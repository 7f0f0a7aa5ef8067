"""The decode-sums' in-place form (``out=``, ``accumulate=``) and the ring hop
built on it, on the CPU:

(a) the plain versions' accumulate form, chained one message at a time (the
    ring's hop), equals JAX's M = 1 kernels in interpret mode added in
    order, bit for bit: the 2-bit sum into int8, int16 and int32 outputs,
    the weighted 2-bit sum and pack8's sum, the float ones run eagerly under
    ``jax.disable_jit()`` (under jit XLA folds the kernels' +0.0 seed);
(b) int8, int16 and int32 outputs equal the int32 sum at M = 127 and 128
    wherever the dtype is at least ``_sum_dtype(M)``, and int8 at M = 128
    equals it modulo 256 (its own wrapping add), which is why the wire
    widens there;
(c) -0.0 products (zero weights on -1 votes, a zero scale on negative
    levels) give +0.0 as JAX's eager references do; accumulating one into a -0.0
    output keeps -0.0, the one case where the fused hop and a decode from
    +0.0 differ, which the ring never meets;
(d) the ring's flat outputs (``PackedVoteWire._ring_sum`` and
    ``_ring_wsum``, ``Pack8Wire._ring`` and ``_ring_bucket``, plain and
    weighted) equal the decode-then-add hop (each message decoded from +0.0
    at M = 1, added to an accumulator, the chunk copied out) bit for bit, in
    one process of 4 workers and in 2 gloo processes of 2;
(e) the output contract's refusals.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before its kernels: the JAX package's own import order)
from repro.kernels.pack2bit import ref as j2ref
from repro.kernels.pack2bit.ops import unpack2bit_sum_op as j_sum
from repro.kernels.pack2bit.ops import unpack2bit_wsum_op as j_wsum
from repro.kernels.pack8 import ref as j8ref
from repro.kernels.pack8.ops import unpack8_sum_op as j_unpack8
from repro_torch.dist.collectives import _sum_dtype
from repro_torch.kernels.common import LANES, canonical_rows
from repro_torch.kernels.pack2bit.kernel import unpack2bit_sum_cuda
from repro_torch.kernels.pack2bit.ops import unpack2bit_sum_op, unpack2bit_wsum_op
from repro_torch.kernels.pack2bit.ref import unpack2bit_sum_ref, unpack2bit_wsum_ref
from repro_torch.kernels.pack8.kernel import unpack8_sum_cuda
from repro_torch.kernels.pack8.ops import unpack8_sum_op
from repro_torch.kernels.pack8.ref import unpack8_sum_ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
M = 4
N = 32 * LANES - 5
ROWS = canonical_rows(N)
WEIGHTS = np.array([0.0, 0.3, 1.7, 0.9], np.float32)   # worker 0: -0.0 products
SCALES = np.array([1.3e-3, 0.0, 0.25, 7.0], np.float32)
PROC_TIMEOUT = 120   # seconds, per process


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _packed(m, seed, rows=ROWS):
    """m random 2-bit messages (code 3 included); worker 0 all -1 votes."""
    p = np.random.RandomState(seed).randint(0, 256, (m, rows, 128)).astype(np.uint8)
    p[0] = 0xAA
    return p


def _levels(m, seed):
    return np.random.RandomState(seed).randint(-127, 128, (m, ROWS, LANES)).astype(np.int8)


def _jax_m1_in_order(kind, data, side):
    """JAX's M = 1 kernel in interpret mode per message, added in worker
    order, eagerly."""
    acc = None
    with jax.disable_jit():
        for i in range(data.shape[0]):
            one = jnp.asarray(data[i:i + 1])
            if kind == "sum":
                d = j_sum(one, N, (N,), interpret=True)
            elif kind == "wsum":
                d = j_wsum(one, jnp.asarray(side[i:i + 1]), N, (N,), interpret=True)
            else:
                d = j_unpack8(one, jnp.asarray(side[i:i + 1]), N, (N,), interpret=True)
            acc = d if acc is None else acc + d
    return torch.from_numpy(np.asarray(acc).copy())


def _port_chain(kind, data, side, dtype):
    """The ring's hop: each message into one output, the first writing it
    (over garbage), every later one adding into it."""
    out = torch.full((ROWS * LANES,), 77, dtype=dtype)
    data, side = torch.from_numpy(data), torch.from_numpy(side)
    for i in range(data.shape[0]):
        if kind == "sum":
            got = unpack2bit_sum_op(data[i:i + 1], N, (N,), out=out, accumulate=i > 0)
        elif kind == "wsum":
            got = unpack2bit_wsum_op(data[i:i + 1], side[i:i + 1], N, (N,), out=out,
                                     accumulate=i > 0)
        else:
            got = unpack8_sum_op(data[i:i + 1], side[i:i + 1], N, (N,), out=out,
                                 accumulate=i > 0)
        assert got.data_ptr() == out.data_ptr() and tuple(got.shape) == (N,)
    return out[:N]


# ----------------------------------------------------- (a) the chain vs JAX

@pytest.mark.parametrize("kind,dtype", [("sum", torch.int8), ("sum", torch.int16),
                                        ("sum", torch.int32), ("wsum", torch.float32),
                                        ("pack8", torch.float32)])
def test_accumulate_chain_equals_jax_m1_kernels_added_in_order(kind, dtype):
    data = _levels(M, 3) if kind == "pack8" else _packed(M, 3)
    side = SCALES if kind == "pack8" else WEIGHTS
    want = _jax_m1_in_order(kind, data, side)
    got = _port_chain(kind, data, side, dtype)
    assert got.dtype == dtype
    if kind == "sum":
        assert torch.equal(got.to(torch.int32), want)
    else:
        assert torch.equal(_bits(got), _bits(want))
    # the fresh form into an output equals the allocating one
    d, s = torch.from_numpy(data), torch.from_numpy(side)
    if kind == "sum":
        fresh = unpack2bit_sum_ref(d, out=torch.full((ROWS, LANES), 5, dtype=dtype))
        assert torch.equal(fresh.to(torch.int32), unpack2bit_sum_ref(d))
    elif kind == "wsum":
        fresh = unpack2bit_wsum_ref(d, s, out=torch.full((ROWS * LANES,), float("nan")))
        assert torch.equal(_bits(fresh), _bits(unpack2bit_wsum_ref(d, s)))
    else:
        fresh = unpack8_sum_ref(d, s, out=torch.full((ROWS * LANES,), float("nan")))
        assert torch.equal(_bits(fresh), _bits(unpack8_sum_ref(d, s)))


# ------------------------------------------- (b) narrow outputs at M = 127, 128

@pytest.mark.parametrize("m", [127, 128])
def test_narrow_outputs_equal_the_int32_sum(m):
    """Column 0 of row 0 is +1 in every message (sum m), column 1 -1 (sum
    -m): the extremes of the int8 range at M = 127, one past it at 128."""
    p = _packed(m, m, rows=32)
    p[:, 0, 0], p[:, 0, 1] = 0x01, 0x02
    n = 32 * LANES
    wide = unpack2bit_sum_ref(torch.from_numpy(p))
    jwant = np.asarray(j_sum(jnp.asarray(p), n, (n,), interpret=True))
    np.testing.assert_array_equal(wide.reshape(-1).numpy(), jwant)
    assert int(wide[0, 0]) == m and int(wide[0, 1]) == -m
    assert _sum_dtype(m) == (torch.int8 if m == 127 else torch.int16)
    g = torch.from_numpy(p)
    for dtype in (torch.int8, torch.int16, torch.int32):
        fresh = unpack2bit_sum_ref(g, out=torch.empty((32, LANES), dtype=dtype))
        chain = torch.full((32, LANES), -3, dtype=dtype)
        for i in range(m):
            unpack2bit_sum_ref(g[i:i + 1], out=chain, accumulate=i > 0)
        for got in (fresh, chain):
            assert torch.equal(got, wide.to(dtype))
            fits = torch.iinfo(dtype).max >= torch.iinfo(_sum_dtype(m)).max
            assert torch.equal(got.to(torch.int32), wide) == fits, dtype
    assert int(fresh.to(torch.int8)[0, 0]) == (127 if m == 127 else -128)


# ------------------------------------------------------------ (c) -0.0 products

def test_negative_zero_products_give_positive_zero_but_keep_a_negative_zero_output():
    """Every product -0.0. JAX's eager references decode each message from
    +0.0, so their M = 1 sums added in order are +0.0, and so is the port's
    chain. JAX's interpret-mode kernels give -0.0 here even under
    ``jax.disable_jit()`` (XLA folds their +0.0 seed): equal in value."""
    p = np.full((M, ROWS, 128), 0xAA, np.uint8)            # every vote -1
    zeros = np.zeros(M, np.float32)
    lv = np.full((M, ROWS, LANES), -5, np.int8)
    for kind, data in (("wsum", p), ("pack8", lv)):
        jref = j2ref.unpack2bit_wsum_ref if kind == "wsum" else j8ref.unpack8_sum_ref
        want = None
        for i in range(M):
            d = np.asarray(jref(jnp.asarray(data[i:i + 1]), jnp.asarray(zeros[i:i + 1])))
            want = d if want is None else want + d
        want = torch.from_numpy(want.reshape(-1)[:N].copy())
        got = _port_chain(kind, data, zeros, torch.float32)
        assert torch.equal(_bits(got), _bits(want)), kind
        assert not bool(torch.signbit(got).any()), kind
        assert torch.equal(got, _jax_m1_in_order(kind, data, zeros)), kind
        # into a -0.0 output: the fused add keeps it; a decode from +0.0
        # added to it gives +0.0
        d, s = torch.from_numpy(data[:1]), torch.from_numpy(zeros[:1])
        out = torch.full((ROWS * LANES,), -0.0)
        fused = (unpack2bit_wsum_ref(d, s, out=out, accumulate=True) if kind == "wsum"
                 else unpack8_sum_ref(d, s, out=out, accumulate=True))
        assert bool(torch.signbit(fused).all()), kind
        decoded = unpack2bit_wsum_ref(d, s) if kind == "wsum" else unpack8_sum_ref(d, s)
        assert not bool(torch.signbit(torch.full((ROWS, LANES), -0.0) + decoded).any())


# ------------------------------------------ (d) the ring vs decode-then-add

CHILD = r"""
import sys
import torch
import torch.distributed as dist
from repro_torch.dist import bucketing, collectives as C
from repro_torch.kernels.common import LANES
from repro_torch.kernels.pack2bit.ref import unpack2bit_sum_ref, unpack2bit_wsum_ref
from repro_torch.kernels.pack8.ref import unpack8_sum_ref
from repro_torch.launch.mesh import make_host_mesh

ROWS, CHUNK = 96, 32
BUCKET_SHAPES = [(33, 129), (9000,), (64, 511)]


def parent_flat(vals, side, decode, rows, dtype, group):
    # each chunk: decodes from +0.0 added into an accumulator, copied out
    out, wtot = torch.empty(rows * LANES, dtype=dtype), None
    for r0, nr in C._ring_chunk_spans(rows, CHUNK):
        acc = C._ring_accumulate(C._row_chunks(vals, r0, nr), side, decode, group)
        if isinstance(acc, tuple):
            acc, wt = acc
            wtot = wt if wtot is None else wtot
        out[r0 * LANES:(r0 + nr) * LANES].copy_(acc)
    return out, wtot


def parent_bucket(payload, side, b, group, weighted):
    outs, wtot = [torch.empty(s.rows * LANES) for s in b.slots], None
    for r0, nr in C._ring_chunk_spans(b.rows, CHUNK):
        segs = C._chunk_segments(b.slots, r0, nr)

        def decode(buf, sc, _segs=segs, _r0=r0):
            res = tuple(unpack8_sum_ref(buf[a - _r0:a - _r0 + k][None], sc[i:i + 1]).reshape(-1)
                        for i, _s, a, k in _segs)
            return res + (sc[-1],) if weighted else res

        part = C._ring_accumulate(C._row_chunks(payload, r0, nr), (side,), decode, group)
        if weighted:
            wtot = part[-1] if wtot is None else wtot
            part = part[:-1]
        for (i, s, a, k), arr in zip(segs, part):
            o = (a - s.row_start) * LANES
            outs[i][o:o + k * LANES].copy_(arr)
    return torch.cat([o[:s.size] for s, o in zip(b.slots, outs)]), wtot


def cases(group):
    gen = torch.Generator().manual_seed(9)
    packed = torch.randint(0, 256, (4, ROWS, 128), generator=gen, dtype=torch.uint8)
    packed[0] = 0xAA                          # worker 0: all -1 votes at weight 0
    levels = torch.randint(-127, 128, (4, ROWS, 512), generator=gen, dtype=torch.int8)
    w = torch.tensor([0.0, 0.3, 1.7, 0.9])
    sc = torch.tensor([1.3e-3, 0.0, 0.25, 7.0])  # worker 1: -0.0 products
    mine = slice(group.rank * group.local, (group.rank + 1) * group.local)
    p2 = C.make_vote_wire("allgather_packed", group, ring_chunk_rows=CHUNK)
    p8 = C.make_vote_wire("allgather_packed", group, wire_format="pack8", ring_chunk_rows=CHUNK)
    n = ROWS * LANES
    res = {"pack2": ((p2._ring_sum(packed[mine]), None), parent_flat(
        packed[mine], (), lambda b: unpack2bit_sum_ref(b[None]).reshape(-1), ROWS,
        C._sum_dtype(4), group))}
    ws = w[mine].reshape(-1, 1)
    res["pack2_weighted"] = (p2._ring_wsum(packed[mine], w[mine]), parent_flat(
        packed[mine], (ws,),
        lambda b, x: (unpack2bit_wsum_ref(b[None], x).reshape(-1), x[0]), ROWS,
        torch.float32, group))
    for weighted in (False, True):
        side = torch.stack([sc * w, w], 1) if weighted else sc.reshape(-1, 1)
        fused = p8._ring(levels[mine], side[mine], n, (n,), weighted=weighted)
        res[f"pack8{'_weighted' * weighted}"] = (
            fused if weighted else (fused, None),
            parent_flat(levels[mine], (side[mine],),
                        lambda b, s: ((unpack8_sum_ref(b[None], s[0:1]).reshape(-1), s[1])
                                      if weighted else
                                      unpack8_sum_ref(b[None], s[0:1]).reshape(-1)),
                        ROWS, torch.float32, group))
    (b,) = bucketing.build_bucket_plan(BUCKET_SHAPES, "pack8").buckets
    payload = torch.randint(-127, 128, (4, b.rows, 512), generator=gen, dtype=torch.int8)
    ssc = torch.rand(4, len(b.slots), generator=gen) * 1e-2
    ssc[1] = 0.0
    for weighted in (False, True):
        side = torch.cat([ssc * w.reshape(-1, 1), w.reshape(-1, 1)], 1) if weighted else ssc
        got = p8._ring_bucket(payload[mine], side[mine], b, weighted=weighted)
        got, wt = got if weighted else (got, None)
        res[f"pack8_bucket{'_weighted' * weighted}"] = (
            (torch.cat([x.reshape(-1) for x in got]), wt),
            parent_bucket(payload[mine], side[mine], b, group, weighted))
    return res


if __name__ == "__main__":
    rank, world, port, out = sys.argv[1:]
    if int(world) > 1:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=int(rank), world_size=int(world))
    try:
        torch.save(cases(make_host_mesh(4)), out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
"""

RING_CASES = ("pack2", "pack2_weighted", "pack8", "pack8_weighted", "pack8_bucket",
              "pack8_bucket_weighted")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """One process of 4 workers and two gloo processes of 2, all at once."""
    tmp = tmp_path_factory.mktemp("ring")
    script = tmp / "child.py"
    script.write_text(CHILD)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(tmp)), "OMP_NUM_THREADS": "1"}
    procs = []
    try:
        for world in (1, 2):
            port = _free_port()
            procs += [(world, r, subprocess.Popen(
                [sys.executable, str(script), str(r), str(world), str(port),
                 str(tmp / f"w{world}r{r}.pt")], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)) for r in range(world)]
        for _, _, p in procs:
            out, _ = p.communicate(timeout=PROC_TIMEOUT)
            assert p.returncode == 0, out[-3000:]
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {(world, r): torch.load(tmp / f"w{world}r{r}.pt") for world, r, _ in procs}


@pytest.mark.parametrize("case", RING_CASES)
def test_ring_outputs_equal_the_decode_then_add_hop(case, ring_runs):
    for (world, rank), res in ring_runs.items():
        (got, gw), (want, ww) = res[case]
        assert got.dtype == want.dtype and got.shape == want.shape, (case, world, rank)
        assert torch.equal(_bits(got), _bits(want)), (case, world, rank)
        assert (gw is None) == (ww is None) and (gw is None or torch.equal(gw, ww))


# ------------------------------------------------------------ (e) refusals

def test_output_contract_refusals():
    p = torch.zeros((2, 32, 128), dtype=torch.uint8)
    lv = torch.zeros((2, 32, LANES), dtype=torch.int8)
    two = torch.ones(2)
    with pytest.raises(ValueError, match="accumulate"):
        unpack2bit_sum_ref(p, accumulate=True)
    with pytest.raises(ValueError, match="accumulate"):
        unpack8_sum_ref(lv, two, accumulate=True)
    with pytest.raises(TypeError, match="dtype"):
        unpack2bit_sum_ref(p, out=torch.zeros(32 * LANES))
    with pytest.raises(TypeError, match="dtype"):
        unpack2bit_wsum_ref(p, two, out=torch.zeros(32 * LANES, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        unpack8_sum_ref(lv, two, out=torch.zeros(32 * LANES + 1))
    with pytest.raises(ValueError, match="contiguous"):
        unpack8_sum_ref(lv, two, out=torch.zeros(2 * 32 * LANES)[::2])
    for call in (lambda: unpack2bit_sum_cuda(p, out=torch.zeros(32 * LANES, dtype=torch.int8)),
                 lambda: unpack8_sum_cuda(lv, two, out=torch.zeros(32 * LANES))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
