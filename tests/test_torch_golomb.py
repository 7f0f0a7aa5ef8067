"""The port's Golomb/Rice entropy-coded vote wire against the JAX package, on
the CPU: the encoder (the plain versions of the fused ``sparsign_golomb`` and
the ``golomb_pack`` kernels) byte for byte against ``golomb_encode_ref``,
capacity overflow and the build-time refusal, the decode-sums bit for bit
against ``ungolomb_sum_ref`` / ``ungolomb_wsum_ref``, ``GolombWire``'s
surface, the wire negotiation, and an M = 4 trainer step on the golomb wire
against the per-worker JAX oracle and against the same step on the 2-bit
packed wire. The kernels themselves are held against these plain versions
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core.algorithm import CompressionConfig as JConfig
from repro.core.budgets import BudgetConfig as JBudget
from repro.dist import collectives as jcoll
from repro.dist import compat as jcompat
from repro.kernels.golomb import ref as jref
from repro.kernels.sparsign.ref import sparsign_ref as j_sparsign
from repro_torch import kernels as tkernels
from repro_torch.core import engine as tengine
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import SPECS, get_spec, tree_leaves
from repro_torch.dist import collectives as tcoll
from repro_torch.kernels.golomb import ref as tref
from repro_torch.kernels.golomb.kernel import (golomb_pack_cuda, sparsign_golomb_cuda,
                                               ungolomb_sum_cuda, ungolomb_wsum_cuda)
from repro_torch.kernels.golomb.ops import (golomb_pack_op, sparsign_golomb_op,
                                            ungolomb_sum_op, ungolomb_wsum_op)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import params_from_numpy
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step
from test_torch_train import M, InjectedModel, _injected, jax_oracle

SPECIALS = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-30, -1e30, -0.0], np.float32)
SIZES = [1, 63, 2331, 5000]
j_encode = jax.jit(jref.golomb_encode_ref, static_argnames=("p",))
j_sum = jax.jit(jref.ungolomb_sum_ref, static_argnums=(1, 2), static_argnames=("p",))
# the weighted reference runs eagerly: under jit XLA folds its +0.0 seed away
# (0.0 + -0.0 becomes -0.0), which is not the reference's association
j_wsum = jref.ungolomb_wsum_ref


def grad_like(n, seed):
    g = np.random.RandomState(seed).randn(n).astype(np.float32) * 0.5
    g[::97] = 0.0
    g[:8] = SPECIALS[:n]
    return g


def ternary(n, density, seed):
    return np.random.RandomState(seed).choice(
        np.array([-1, 0, 1], np.int8), size=n, p=[density / 2, 1.0 - density, density / 2])


def headers(payload):
    flat = np.asarray(payload).reshape(-1)
    return (int.from_bytes(flat[:4].tobytes(), "little"),
            int.from_bytes(flat[4:8].tobytes(), "little"))


def f32bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def jax_messages(n, p, count, seed, density=None):
    """``count`` coded messages of sparsign draws (JAX's encoder), stacked."""
    g = jnp.asarray(grad_like(n, seed))
    budget = (density or p) / 0.4
    return np.stack([np.array(j_encode(j_sparsign(g, budget, seed + i, 0), p=p))
                     for i in range(count)])


# ---------------------------------------------------------------- the encoder

@pytest.mark.parametrize("p", [0.01, 0.05, 0.2])
def test_encode_matches_jax(p):
    """sparsign -> coded stream, fused op and two-pass chain, byte for byte
    JAX's ``golomb_encode_ref`` of JAX's sparsign, in f32 and bf16, counter
    bases 0 and 2^32 - 5000, over sizes from 1 to 5,000 (the budget puts the
    density near the plan; 1.5 overflows the capacity)."""
    for n in SIZES:
        try:
            rows = jref.golomb_rows(n, p)
        except ValueError:   # capacity loses to pack2 at this size
            with pytest.raises(ValueError, match="does not beat"):
                tref.golomb_rows(n, p)
            continue
        assert tref.golomb_rows(n, p) == rows
        for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            g = grad_like(n, n)
            tg, jg = torch.from_numpy(g).to(dtype), jnp.asarray(g, jdtype)
            for budget, seed, cb in ((p / 0.4, 11, 0), (p / 0.4, 12, 2**32 - 5000),
                                     (1.5, 13, 7)):
                want = np.asarray(j_encode(j_sparsign(jg, budget, seed, cb), p=p))
                got = sparsign_golomb_op(tg, budget, seed, cb, p=p)
                assert got.dtype == torch.uint8 and got.shape == (rows, tref.ROW_BYTES)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{n} {dtype} {cb}")
                t = get_spec("sparsign").values(tg, budget, seed, cb)
                np.testing.assert_array_equal(golomb_pack_op(t, p=p).numpy(), want)


def test_overflow_truncates_a_suffix_and_counts_dropped():
    """A message denser than the plan ships a prefix of its codes; the header
    says how many shipped and how many dropped, as JAX's encoder does."""
    p, n = 0.05, 4099
    for t in (np.ones(n, np.int8), ternary(n, 0.6, 1)):
        want = np.asarray(j_encode(jnp.asarray(t), p=p))
        got = tref.golomb_encode_ref(torch.from_numpy(t), p=p).numpy()
        np.testing.assert_array_equal(got, want)
        shipped, dropped = headers(got)
        assert dropped > 0 and shipped + dropped == int(np.count_nonzero(t))
        back = tref.golomb_decode_ref(torch.from_numpy(got), n, (n,), p=p).numpy()
        keep = np.flatnonzero(t)[:shipped]
        expect = np.zeros(n, np.int8)
        expect[keep] = t[keep]
        np.testing.assert_array_equal(back, expect)
    bits = (tref.golomb_rows(n, p) * tref.ROW_BYTES - tref.HEADER_BYTES) * 8
    assert headers(tref.golomb_encode_ref(torch.ones(n, dtype=torch.int8), p=p))[0] == \
        bits // (2 + tref.rice_b(p))


def test_capacity_that_loses_to_pack2_is_a_build_error():
    for n, p in ((1 << 16, 0.5), (1 << 20, 0.6), (707_788_800, 0.5)):
        with pytest.raises(ValueError, match="does not beat"):
            jref.golomb_rows(n, p)
        with pytest.raises(ValueError, match="does not beat"):
            tref.golomb_rows(n, p)
    for n in (1, 63, 1000, 1 << 16, 707_788_800):
        for p in (0.001, 0.01, 0.05, 0.2):
            try:
                want = jref.golomb_rows(n, p)
            except ValueError:
                with pytest.raises(ValueError):
                    tref.golomb_rows(n, p)
                continue
            assert tref.golomb_rows(n, p) == want
            assert tref.golomb_nbytes(n, p) == jref.golomb_nbytes(n, p)
            assert tref.rice_b(p) == jref.rice_b(p)
    assert tref.golomb_nbytes(1 << 16, 0.05) < tcoll.packed_nbytes(1 << 16)


def test_roundtrip_extremes():
    """A zero message codes to zero bytes and decodes to zero; a lone nonzero
    at the last coordinate is the longest unary run; zero padding emits no
    code, so a padded view codes as the unpadded message."""
    p, n = 0.05, 5000
    zero = tref.golomb_encode_ref(torch.zeros(n, dtype=torch.int8), p=p)
    assert not zero.any() and not tref.golomb_decode_ref(zero, n, (n,), p=p).any()
    t = torch.zeros(n, dtype=torch.int8)
    t[-1] = -1
    lone = tref.golomb_encode_ref(t, p=p)
    np.testing.assert_array_equal(lone.numpy(), np.asarray(j_encode(jnp.asarray(t.numpy()), p=p)))
    assert headers(lone) == (1, 0)
    np.testing.assert_array_equal(tref.golomb_decode_ref(lone, n, (n,), p=p).numpy(), t.numpy())
    wide = torch.zeros(3 * n, dtype=torch.int8)
    wide[:n] = t
    coded = tref.golomb_encode_ref(wide, p=p)
    assert headers(coded) == (1, 0)
    np.testing.assert_array_equal(tref.golomb_decode_ref(coded, 3 * n, (3 * n,), p=p).numpy(),
                                  wide.numpy())


# ------------------------------------------------------------ the decode-sums

@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("n", [63, 5000])
def test_decode_sums_match_jax(m, n):
    """Real encoder outputs (the last of three an all-zero, masked worker),
    summed in int32 and weighted in float32 (zero, fractional and negative
    weights), bit for bit JAX's plain decode-sums."""
    p = 0.05
    msgs = jax_messages(n, p, m, 3 * n + m)
    if m == 3:
        msgs[2] = 0
    want = np.asarray(j_sum(jnp.asarray(msgs), n, (n,), p=p))
    tm = torch.from_numpy(msgs)
    got = ungolomb_sum_op(tm, n, (n,), p=p)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = sum(np.asarray(jref.golomb_decode_ref(jnp.asarray(x), n, (n,), p=p), np.int32)
                 for x in msgs)
    np.testing.assert_array_equal(got.numpy(), oracle)
    for w in (np.array([0.0, 0.3, -1.7], np.float32)[:m], np.array([0.7, 0.0, 1.25])[:m]):
        jw = np.asarray(j_wsum(jnp.asarray(msgs), jnp.asarray(w, jnp.float32), n, (n,), p=p))
        tw = ungolomb_wsum_op(tm, torch.from_numpy(w), n, (n,), p=p)
        assert tw.dtype == torch.float32
        np.testing.assert_array_equal(f32bits(tw.numpy()), f32bits(jw))
    if m == 1:   # a zero weight times a -1 vote is -0.0; the +0.0 seed turns it into +0.0
        z = ungolomb_wsum_op(tm, torch.zeros(1), n, (n,), p=p).numpy()
        assert not np.signbit(z).any()


def test_wrappers_refuse_cpu_tensors_and_ops_count_no_launch():
    """A wrapper launches its kernel or raises; on the CPU the ops take the
    plain versions and count no launch."""
    g, one = torch.zeros(600), torch.ones(1)
    seed = torch.zeros(1, dtype=torch.int64)
    msgs = torch.zeros((2, 3, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        sparsign_golomb_cuda(g, one, seed, b=4, rows=3)
    with pytest.raises(ValueError, match="CUDA"):
        golomb_pack_cuda(g.to(torch.int8), b=4, rows=3)
    with pytest.raises(ValueError, match="CUDA"):
        ungolomb_sum_cuda(msgs, 600, b=4)
    with pytest.raises(ValueError, match="CUDA"):
        ungolomb_wsum_cuda(msgs, torch.ones(2), 600, b=4)
    tkernels.reset_launch_counts()
    coded = sparsign_golomb_op(torch.from_numpy(grad_like(600, 1)), 0.1, 3)
    golomb_pack_op(torch.ones(600, dtype=torch.int8), p=0.2)
    ungolomb_sum_op(coded[None], 600, (600,))
    ungolomb_wsum_op(coded[None], torch.ones(1), 600, (600,))
    assert all(v == 0 for v in tkernels.launch_counts().values())


# ------------------------------------------------------------------ the wire

@pytest.mark.parametrize("m", [1, 4, 20])
@pytest.mark.parametrize("elastic", [False, True])
def test_golomb_wire_ledger_and_gather_hbm_match_jax(m, elastic):
    part = tcoll.ParticipationSpec(dropout=0.25) if elastic else None
    jpart = jcoll.ParticipationSpec(dropout=0.25) if elastic else None
    for p in (0.01, 0.05):
        tw = tcoll.make_vote_wire("allgather_packed", make_mesh((m,), ("data",)),
                                  wire_format="golomb", golomb_p=p, participation=part)
        jw = jcoll.GolombWire(axes=("data",), n_workers=m, p=p, participation=jpart)
        assert isinstance(tw, tcoll.GolombWire) and tw.native_format == jw.native_format
        for n in (4099, 1 << 16, 6912 * 2560, 707_788_800):
            for mode in ("votes", "scaled_votes"):
                assert tcoll.uplink_ledger(mode, tw, n) == jcoll.uplink_ledger(mode, jw, n)
            assert tw.wire_bytes(n) == jw.wire_bytes(n)
            assert tw.weight_bytes() == jw.weight_bytes()
            assert tw.gather_hbm_bytes(n) == jw.gather_hbm_bytes(n)
            assert tw.payload_rows(n) == jw.payload_rows(n)
            assert tcoll.golomb_payload_nbytes(n, p) == jcoll.golomb_payload_nbytes(n, p)


def test_golomb_wire_headers_mask_and_exchange_match_jax():
    p, n = 0.05, 5000
    jw = jcoll.GolombWire(axes=("data",), n_workers=4, p=p)
    tw = tcoll.make_vote_wire("allgather_packed", make_mesh((4,), ("data",)),
                              wire_format="golomb", golomb_p=p,
                              participation=tcoll.ParticipationSpec())
    for coded in (jax_messages(n, p, 1, 5)[0],
                  np.array(j_encode(jnp.ones(n, jnp.int8), p=p))):
        tc = torch.from_numpy(coded)
        assert float(tw.message_nnz(tc)) == float(jw.message_nnz(jnp.asarray(coded)))
        assert float(tw.message_dropped(tc)) == float(jw.message_dropped(jnp.asarray(coded)))
        for keep in (True, False):
            np.testing.assert_array_equal(
                tw.mask_message(tc, torch.tensor(keep)).numpy(),
                np.asarray(jw.mask_message(jnp.asarray(coded), jnp.bool_(keep))))
    msgs = jax_messages(n, p, 4, 9)
    msgs[1] = 0
    got = tw.exchange(torch.from_numpy(msgs), n, (n,))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_sum(jnp.asarray(msgs), n, (n,), p=p)))
    w = np.array([1.5, 0.0, 2.0, 0.25], np.float32)
    wv, wtot = tw.exchange_weighted(torch.from_numpy(msgs), n, (n,), weight=torch.from_numpy(w))
    np.testing.assert_array_equal(f32bits(wv.numpy()), f32bits(
        j_wsum(jnp.asarray(msgs), jnp.asarray(w), n, (n,), p=p)))
    assert float(wtot) == float(w.sum())
    with pytest.raises(ValueError, match="pack8"):
        tw.exchange(torch.from_numpy(msgs), n, (n,), scale=1.0)


def _jax_error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e)
    return None


def test_make_vote_wire_golomb_validation_matches_jax():
    jflat = jcompat.make_mesh((1, 1), ("data", "model"))
    jhier = jcompat.make_mesh((1, 1), ("pod", "data"))
    flat, hier = make_mesh((1,), ("data",)), make_mesh((1, 1), ("pod", "data"))
    for impl, kw in (("psum", {"golomb_p": 0.05}), ("hier", {"golomb_p": 0.05}),
                     ("allgather_packed", {}), ("allgather_packed", {"golomb_p": 0.0}),
                     ("allgather_packed", {"golomb_p": 1.0})):
        on_hier = impl == "hier"
        jerr = _jax_error(lambda: jcoll.make_vote_wire(
            impl, ("pod", "data") if on_hier else ("data",), jhier if on_hier else jflat,
            wire_format="golomb", **kw))
        assert jerr is not None, (impl, kw)
        with pytest.raises(jerr):
            tcoll.make_vote_wire(impl, hier if on_hier else flat, wire_format="golomb", **kw)
    wire = tcoll.make_vote_wire("allgather_packed", flat, wire_format="golomb", golomb_p=0.05,
                                backend="torch")
    assert isinstance(wire, tcoll.GolombWire) and wire.p == 0.05 and wire.backend == "torch"
    ring = tcoll.make_vote_wire("allgather_packed", flat, wire_format="golomb", golomb_p=0.05,
                                ring_chunk_rows=64)
    assert isinstance(ring, tcoll.GolombWire) and ring.ring_chunk_rows == 64


@pytest.mark.parametrize("name", list(SPECS))
def test_wire_negotiation_matches_jax(name):
    """wire_mode and wire_payload_format for every ported row, server and
    vote impl, as the JAX engine answers them (a golomb row rides int8 votes
    on psum and hier)."""
    for server in ("majority_vote", "scaled_sign_ef", "mean"):
        for impl in tcoll.VOTE_IMPLS:
            jc, tc = JConfig(compressor=name, server=server), CompressionConfig(
                compressor=name, server=server)
            mode = jengine.wire_mode(jc, vote_impl=impl)
            assert tengine.wire_mode(tc, vote_impl=impl) == mode
            assert (tengine.wire_payload_format(tc, mode, vote_impl=impl)
                    == jengine.wire_payload_format(jc, mode, vote_impl=impl)), (server, impl)


def test_resolve_golomb_p_matches_jax():
    for kind, value, explicit in (("target_sparsity", 0.05, None), ("fixed", 1.0, 0.02),
                                  ("target_sparsity", 0.05, 0.1), ("fixed", 1.0, None),
                                  ("l2_norm", 0.1, None), ("fixed", 1.0, 1.0),
                                  ("target_sparsity", 0.0, None)):
        jc = JConfig(compressor="sparsign_golomb", budget=JBudget(kind=kind, value=value))
        tc = CompressionConfig(compressor="sparsign_golomb",
                               budget=BudgetConfig(kind=kind, value=value))
        jerr = _jax_error(lambda: jengine.resolve_golomb_p(jc, explicit))
        if jerr is None:
            assert tengine.resolve_golomb_p(tc, explicit) == jengine.resolve_golomb_p(jc, explicit)
        else:
            with pytest.raises(jerr):
                tengine.resolve_golomb_p(tc, explicit)


@pytest.mark.parametrize("budget_kind", ["fixed", "target_sparsity"])
def test_compress_leaf_on_the_golomb_wire_matches_jax(budget_kind):
    """engine.compress_leaf into the coded stream (plain versions) against
    JAX's jnp backend, and the pack2 wire refuses the golomb row."""
    p, n = 0.05, 4099
    value = 0.12 if budget_kind == "fixed" else p
    g = grad_like(n, 21)
    jc = JConfig(compressor="sparsign_golomb", budget=JBudget(kind=budget_kind, value=value))
    tc = CompressionConfig(compressor="sparsign_golomb",
                           budget=BudgetConfig(kind=budget_kind, value=value))
    jw = jcoll.GolombWire(axes=("data",), n_workers=4, p=p)
    tw = tcoll.make_vote_wire("allgather_packed", make_mesh((4,), ("data",)),
                              wire_format="golomb", golomb_p=p)
    want = jengine.compress_leaf(jnp.asarray(g), jc, 77, 5, backend="jnp", wire=jw).values
    got = tengine.compress_leaf(torch.from_numpy(g), tc, 77, 5, wire=tw).values
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    packed = tcoll.make_vote_wire("allgather_packed", make_mesh((4,), ("data",)))
    with pytest.raises(ValueError, match="declares wire format 'golomb'"):
        tengine.compress_leaf(torch.from_numpy(g), tc, 77, wire=packed)


# ------------------------------------------------------ the trainer, M = 4

@pytest.mark.parametrize("elastic", [False, True])
def test_m4_golomb_step_matches_the_jax_oracle_and_the_pack2_wire(elastic):
    """Two rounds at M = 4 with injected gradients on the golomb wire (a
    fixed budget, an explicit plan fraction): bit for bit the per-worker JAX
    oracle on JAX's golomb wire, and the same step of ``sparsign`` on the
    2-bit packed wire (the same votes on two encodings)."""
    weights = (1.5, 0.5, 2.0, 1.0) if elastic else None
    dropout = 0.25 if elastic else 0.0
    jpart = jcoll.ParticipationSpec(weights=weights, dropout=dropout) if elastic else None
    tpart = tcoll.ParticipationSpec(weights=weights, dropout=dropout) if elastic else None
    golomb_p = 0.3
    jcomp = JConfig(compressor="sparsign_golomb", budget=JBudget(value=0.5),
                    server="majority_vote")
    steps = {}
    for name in ("sparsign_golomb", "sparsign"):
        comp = CompressionConfig(compressor=name, budget=BudgetConfig(value=0.5),
                                 server="majority_vote")
        steps[name] = build_train_step(InjectedModel(), TrainStepConfig(
            compression=comp, lr=LrSchedule(base=0.05), vote_impl="allgather_packed",
            participation=tpart, golomb_p=golomb_p), make_mesh((M,), ("data",)))
    assert steps["sparsign_golomb"].wire.native_format == "golomb"
    assert steps["sparsign"].wire.native_format == "pack2"
    params, _, _ = _injected(0)

    def state_of(leaves):
        return init_state(params_from_numpy({"blocks": ({"a": leaves[0], "b": leaves[1]},),
                                             "embed": leaves[2], "final_norm": leaves[3]}),
                          server="majority_vote", seed=11)

    states = {name: state_of(params) for name in steps}
    for r in range(2):
        _, per, batch = _injected(r + 1)
        want = jax_oracle(params, per, jcomp, seed=11, step=r, lr=np.float32(0.05), part=jpart,
                          golomb_p=golomb_p)
        got = {}
        for name, step in steps.items():
            states[name], metrics = step(states[name], batch)
            got[name] = [t.numpy().copy() for t in tree_leaves(states[name].params)]
            if name == "sparsign_golomb":
                assert float(metrics["nnz_dropped"]) == 0.0
                assert float(metrics["nnz_frac"]) > 0.0
        for a, b, c in zip(got["sparsign_golomb"], want, got["sparsign"]):
            np.testing.assert_array_equal(f32bits(a), f32bits(b))
            np.testing.assert_array_equal(f32bits(a), f32bits(c))
        assert any((a != p).any() for a, p in zip(got["sparsign_golomb"], params))
        params = got["sparsign_golomb"]
