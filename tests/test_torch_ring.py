"""The port's ring-pipelined gather (``ring_chunk_rows``) against the JAX
package's, on the CPU:

(a) the chunk framing (``ring_perm``, ``_ring_chunk_spans``,
    ``_slot_groups``, ``_chunk_segments``) equals JAX's;
(b) at M = 4, per leaf and per bucket, the ring equals the monolithic
    exchange bit for bit on the integer sums (pack2, golomb) and on the
    weighted sums with dyadic weights; with weights that are not dyadic the
    weighted ring equals the sum of JAX's M = 1 decodes in the ring's order
    (0, 3, 2, 1);
(c) pack8's ring equals JAX's ring-order oracle bit for bit: JAX's
    ``unpack8_sum_op`` in interpret mode at M = 1 per worker, added in the
    order 0, 3, 2, 1, run eagerly under ``jax.disable_jit()`` (under jit XLA
    folds the kernel's +0.0 seed); against the monolithic sum it differs by
    rounding only, held to 4 float32 ulps of the largest term;
(d) the port's M = 1 bucketed ring step equals JAX's ``build_train_step``
    (``bucketed=True, ring_chunk_rows=32``) bit for bit on the pack2, golomb
    and pack8 wires: parameters, wire bytes and gathered-payload memory,
    from injected gradients both sides differentiate exactly;
(e) the refusals (a ring on psum, 33 rows, 0 rows) are JAX's.

Messages come from the port's own encoders (the plain versions), which the
wire tests hold byte for byte against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from repro.core import engine as jengine
from repro.core.algorithm import CompressionConfig as JConfig
from repro.core.budgets import BudgetConfig as JBudget
from repro.dist import bucketing as jbuck
from repro.dist import collectives as jcoll
from repro.dist import compat as jcompat
from repro.kernels.pack8.ops import unpack8_sum_op as j_unpack8_sum
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.train.state import LrSchedule as JLr
from repro.train.state import init_state as j_init_state
from repro.train.step_simple import TrainStepConfig as JStepConfig
from repro.train.step_simple import build_train_step as j_build
from repro_torch.core import engine as tengine
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import tree_leaves
from repro_torch.dist import bucketing as tbuck
from repro_torch.dist import collectives as tcoll
from repro_torch.dist.collectives import ParticipationSpec, WorkerGroup
from repro_torch.kernels.golomb.ref import ungolomb_wsum_ref
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import params_from_numpy
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step

from test_torch_train import SHAPES, InjectedModel, f32bits
from test_torch_wire import _jax_error

M = 4
RING_ORDER = (0, 3, 2, 1)   # worker 0's replica: itself, then w - 1, w - 2, ...
GROUP = WorkerGroup(("data",), (M,))
DYADIC = (1.5, 0.5, 2.0, 1.0)
NON_DYADIC = (0.3, 1.7, 0.9, 1.1)
LEAF_N = 40000               # 96 canonical rows: three 32-row chunks
BUCKET_SHAPES = [(33, 129), (9000,), (64, 511)]
GOLOMB_P = 0.05

COMPS = {"pack2": CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                                    server="majority_vote"),
         "golomb": CompressionConfig(compressor="sparsign_golomb",
                                     budget=BudgetConfig(value=0.05), server="majority_vote"),
         "pack8": CompressionConfig(compressor="qsgd8", server="mean")}


def _wire(fmt, ring, part=None):
    return tcoll.make_vote_wire("allgather_packed", GROUP, wire_format=fmt,
                                golomb_p=GOLOMB_P if fmt == "golomb" else None,
                                ring_chunk_rows=ring,
                                participation=ParticipationSpec(weights=part) if part else None)


def _messages(fmt, shape, seed):
    """M workers' wire-native messages of one leaf (worker 2 silent: all
    zero) and their decode scales."""
    wire = _wire(fmt, None)
    g = torch.from_numpy(np.random.RandomState(seed).randn(M, *shape).astype(np.float32))
    msgs, scales = [], []
    for w in range(M):
        msg = tengine.compress_leaf(g[w], COMPS[fmt], 1000 * seed + w, wire=wire)
        msgs.append(wire.mask_message(msg.values, torch.tensor(w != 2)))
        scales.append(msg.scale)
    return torch.stack(msgs), torch.stack(scales).reshape(-1)


# ------------------------------------------------------------ (a) framing

def _pack8_plans(sizes, cap=None):
    return (jbuck.build_bucket_plan([jax.ShapeDtypeStruct((n,), jnp.float32) for n in sizes],
                                    "pack8", bucket_bytes=cap),
            tbuck.build_bucket_plan([(n,) for n in sizes], "pack8", bucket_bytes=cap))


def _key(slot):
    return (slot.index, slot.size, tuple(slot.shape), slot.row_start, slot.rows)


def test_chunk_framing_matches_jax():
    for m in (1, 2, 4, 7):
        assert tcoll.ring_perm(m) == jcoll.ring_perm(m)
    for total in (1, 8, 32, 70, 96, 97, 320, 1382400):
        for chunk in (None, 32, 64, 96, 256, 8192):
            assert (tcoll._ring_chunk_spans(total, chunk)
                    == jcoll._ring_chunk_spans(total, chunk)), (total, chunk)
    jp, tp = _pack8_plans([1000, 513, 4096, 70000, 33, 40000])
    (jb,), (tb,) = jp.buckets, tp.buckets
    for cap in (None, 32, 64, 128, 256):
        jg = jcoll._slot_groups(jb.slots, cap)
        tg = tcoll._slot_groups(tb.slots, cap)
        assert [[_key(s) for s in g] for g in tg] == [[_key(s) for s in g] for g in jg]
    for chunk in (32, 64, 96):
        for r0, nr in tcoll._ring_chunk_spans(tb.rows, chunk):
            js = jcoll._chunk_segments(jb.slots, r0, nr)
            ts = tcoll._chunk_segments(tb.slots, r0, nr)
            assert [(i, _key(s), a, k) for i, s, a, k in ts] == \
                [(i, _key(s), a, k) for i, s, a, k in js]


# ------------------------------------------- (b) integer and weighted sums

def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("weights", [None, DYADIC])
@pytest.mark.parametrize("fmt", ["pack2", "golomb"])
def test_ring_equals_the_monolithic_exchange(fmt, weights):
    """Per leaf at 32 and 256 rows (a golomb leaf is one chunk either way),
    from a stack and from a list of messages, and per bucket (one bucket,
    and capped buckets): bit for bit the monolithic gather."""
    msgs, _ = _messages(fmt, (LEAF_N,), 1)
    mono = _wire(fmt, None, weights)
    w = torch.tensor(weights if weights else (1.0,) * M, dtype=torch.float32)

    def exchange(wire, values, n):
        if weights is None:
            return wire.exchange(values, n, (n,))
        return wire.exchange_weighted(values, n, (n,), weight=w)

    want = exchange(mono, msgs, LEAF_N)
    for ring in (32, 256):
        for values in (msgs, list(msgs)):
            got = exchange(_wire(fmt, ring, weights), values, LEAF_N)
            if weights is None:
                assert got.dtype == want.dtype == torch.int8
                assert torch.equal(got, want)
            else:
                assert torch.equal(_bits(got[0]), _bits(want[0]))
                assert torch.equal(got[1], want[1])
    # buckets: slots equal the per-leaf exchanges
    parts = [_messages(fmt, s, 10 + k) for k, s in enumerate(BUCKET_SHAPES)]
    rows_fn = mono.payload_rows if fmt == "golomb" else None
    for cap in (None, 4096):
        plan = tbuck.build_bucket_plan(BUCKET_SHAPES, fmt, bucket_bytes=cap, rows_fn=rows_fn)
        for b in plan.buckets:
            payload = torch.stack([tbuck.assemble_bucket(
                [tbuck.as_rows(parts[s.index][0][j], fmt, s.rows) for s in b.slots], b, fmt)
                for j in range(M)])
            for ring in (None, 32):
                wire = _wire(fmt, ring, weights)
                if weights is None:
                    got = wire.exchange_bucket(payload, b)
                else:
                    got, wtot = wire.exchange_bucket_weighted(payload, b, weight=w)
                    assert float(wtot) == float(sum(weights))
                for s, agg in zip(b.slots, got):
                    ref = exchange(mono, parts[s.index][0], s.size)
                    ref = ref if weights is None else ref[0]
                    assert tuple(agg.shape) == s.shape
                    assert torch.equal(_bits(agg.reshape(-1)), _bits(ref)), (cap, ring, s)


def test_weighted_ring_sums_in_ring_order():
    """Weights that are not dyadic: the weighted ring is the sum of the M = 1
    weighted decodes in the ring's order (JAX's jnp reference for pack2, the
    port's plain decode for golomb), and W adds up in the same order."""
    w = torch.tensor(NON_DYADIC, dtype=torch.float32)
    for fmt in ("pack2", "golomb"):
        msgs, _ = _messages(fmt, (LEAF_N,), 2)
        got, wtot = _wire(fmt, 32, NON_DYADIC).exchange_weighted(msgs, LEAF_N, (LEAF_N,),
                                                                 weight=w)
        acc = wacc = None
        for m in RING_ORDER:
            if fmt == "pack2":
                d = torch.from_numpy(np.asarray(jcoll._packed_decode_wsum(
                    jnp.asarray(msgs[m].numpy())[None], jnp.asarray(w[m:m + 1].numpy()),
                    LEAF_N, (LEAF_N,), backend="jnp")).copy())
            else:
                d = ungolomb_wsum_ref(msgs[m][None], w[m:m + 1], LEAF_N, (LEAF_N,),
                                      p=GOLOMB_P)
            acc = d if acc is None else acc + d
            wacc = w[m] if wacc is None else wacc + w[m]
        assert torch.equal(_bits(got), _bits(acc)), fmt
        assert torch.equal(_bits(wtot), _bits(wacc)), fmt


# ---------------------------------------------------------------- (c) pack8

def _jax_ring_order(levels, scales, n):
    """JAX's ring-order sum: the interpret-mode kernel at M = 1 per worker,
    added in RING_ORDER, eagerly."""
    with jax.disable_jit():
        acc = None
        for m in RING_ORDER:
            d = j_unpack8_sum(jnp.asarray(levels[m].numpy())[None],
                              jnp.asarray(scales[m:m + 1].numpy()), n, (n,), interpret=True)
            acc = d if acc is None else acc + d
    return torch.from_numpy(np.asarray(acc).copy())


def test_pack8_ring_matches_the_jax_ring_order_oracle():
    levels, scales = _messages("pack8", (LEAF_N,), 3)
    want = _jax_ring_order(levels, scales, LEAF_N)
    mono = _wire("pack8", None).exchange(levels, LEAF_N, (LEAF_N,), scale=scales)
    for ring in (32, 256):
        got = _wire("pack8", ring).exchange(list(levels), LEAF_N, (LEAF_N,), scale=scales)
        assert torch.equal(_bits(got), _bits(want)), ring
    # the monolithic sum in worker order differs by rounding only
    ulp = torch.finfo(torch.float32).eps * float(scales.abs().max()) * 127
    assert float((mono - want).abs().max()) <= 4 * ulp
    # weighted: [scale * w, w] rides the ring; W adds up in ring order
    w = torch.tensor(NON_DYADIC, dtype=torch.float32)
    got, wtot = _wire("pack8", 32, NON_DYADIC).exchange_weighted(levels, LEAF_N, (LEAF_N,),
                                                                 weight=w, scale=scales)
    assert torch.equal(_bits(got), _bits(_jax_ring_order(levels, scales * w, LEAF_N)))
    assert float(wtot) == float(((w[0] + w[3]) + w[2]) + w[1])
    # buckets: each slot is the per-leaf ring (every coordinate sums in ring order)
    parts = [_messages("pack8", s, 20 + k) for k, s in enumerate(BUCKET_SHAPES)]
    plan = tbuck.build_bucket_plan(BUCKET_SHAPES, "pack8")
    (b,) = plan.buckets
    payload = torch.stack([tbuck.assemble_bucket(
        [tbuck.as_rows(parts[s.index][0][j], "pack8", s.rows) for s in b.slots], b, "pack8")
        for j in range(M)])
    sc = torch.stack([parts[s.index][1] for s in b.slots], dim=1)
    for ring in (32, 64):
        got = _wire("pack8", ring).exchange_bucket(payload, b, scale=sc)
        for s, agg in zip(b.slots, got):
            want = _jax_ring_order(parts[s.index][0], parts[s.index][1], s.size)
            assert torch.equal(_bits(agg.reshape(-1)), _bits(want)), (ring, s)


# ------------------------------------------------- (d) the M = 1 step vs JAX

class JInjected:
    """test_torch_train's injected model in JAX: loss = sum_i <p_i, g_i>, so
    jax.grad gives each g_i exactly."""

    def param_shapes(self):
        return jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct(tuple(s.shape), jnp.float32), SHAPES,
            is_leaf=lambda s: hasattr(s, "shape"))

    def loss(self, params, batch):
        leaves = jax.tree_util.tree_leaves(params)
        total = sum(jnp.sum(p * batch[f"g{i}"][0]) for i, p in enumerate(leaves))
        return total, {"loss": total}


LR = 0.0625
STEP_COMPS = {"pack2": ("sparsign", 2.0, "majority_vote", None),
              "golomb": ("sparsign_golomb", 0.5, "majority_vote", 0.3),
              "pack8": ("qsgd8", 1.0, "mean", None)}


@pytest.mark.parametrize("fmt", list(STEP_COMPS))
def test_m1_bucketed_ring_step_matches_jax(fmt):
    """Two steps at M = 1 with ``bucketed=True, ring_chunk_rows=32`` in both
    packages from the same weights and gradients (multiples of 1/8, so
    qsgd8's L2 scale is exact): parameters, wire bytes and gathered-payload
    memory bit for bit. Two quirks of XLA's jitted step on the CPU are
    stepped round, not loosened: the learning rate is 2^-4, so ``lr *
    update`` is exact and XLA's fused multiply-add in the mean server
    (ROADMAP.md section 3) rounds as the port does; and XLA divides the nnz
    count by the constant coordinate total as a product with its
    reciprocal, so ``nnz_frac`` is held to that product of the port's
    count."""
    name, budget, server, golomb_p = STEP_COMPS[fmt]
    mesh = j_host_mesh(1, 1)
    jstep = j_build(JInjected(), JStepConfig(
        compression=JConfig(compressor=name, budget=JBudget(value=budget), server=server),
        lr=JLr(base=LR), worker_axes=("data",), vote_impl="allgather_packed", donate=False,
        bucketed=True, ring_chunk_rows=32, golomb_p=golomb_p), mesh)
    tstep = build_train_step(InjectedModel(), TrainStepConfig(
        compression=CompressionConfig(compressor=name, budget=BudgetConfig(value=budget),
                                      server=server),
        lr=LrSchedule(base=LR), vote_impl="allgather_packed", bucketed=True,
        ring_chunk_rows=32, golomb_p=golomb_p), make_host_mesh(1))
    assert tstep.wire.native_format == fmt and tstep.wire.ring_chunk_rows == 32
    rng = np.random.RandomState(7)
    shapes = [tuple(s.shape) for s in tree_leaves(SHAPES)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    tree = {"blocks": ({"a": params[0], "b": params[1]},), "embed": params[2],
            "final_norm": params[3]}
    jstate = jax.device_put(j_init_state(jax.tree_util.tree_map(jnp.asarray, tree),
                                         server=server, seed=5),
                            NamedSharding(mesh, PartitionSpec()))
    tstate = init_state(params_from_numpy(tree), server=server, seed=5)
    for step in range(2):
        batch = {f"g{i}": (rng.randint(-16, 17, (1,) + s) / 8).astype(np.float32)
                 for i, s in enumerate(shapes)}
        with jcompat.set_mesh(mesh):
            jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tmet = tstep(tstate, batch)
        for k in ("wire_bytes_per_device", "gather_hbm_bytes", "participated"):
            assert f32bits(tmet[k]) == f32bits(jmet[k]), (step, k)
        total = np.float32(sum(int(np.prod(s)) for s in shapes))
        count = np.float32(round(float(tmet["nnz_frac"]) * float(total)))
        assert f32bits(tmet["nnz_frac"]) == f32bits(count / total)
        assert f32bits(jmet["nnz_frac"]) == f32bits(count * (np.float32(1.0) / total))
        assert float(tmet["gather_hbm_bytes"]) > 0.0
        jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate.params)]
        tl = [t.numpy() for t in tree_leaves(tstate.params)]
        for a, b in zip(tl, jl):
            np.testing.assert_array_equal(f32bits(a), f32bits(b))
    assert any((a != p).any() for a, p in zip(tl, params)), "the steps must move"


# --------------------------------------------------------- (e) refusals

def test_ring_refusals_match_jax():
    jflat = jcompat.make_mesh((1, 1), ("data", "model"))
    flat = make_host_mesh(1)
    for impl, rows in (("psum", 32), ("hier", 32), ("allgather_packed", 33),
                       ("allgather_packed", 0), ("allgather_packed", -32)):
        jaxes = ("data", "model") if impl == "hier" else ("data",)
        jerr = _jax_error(lambda: jcoll.make_vote_wire(impl, jaxes, jflat,
                                                       ring_chunk_rows=rows))
        assert jerr is not None, (impl, rows)
        with pytest.raises(jerr):
            tcoll.make_vote_wire(impl, flat if impl != "hier" else
                                 WorkerGroup(("pod", "data"), (1, 1)), ring_chunk_rows=rows)
        jerr = _jax_error(lambda: jengine.resolve_ring_chunk_rows(rows, impl))
        assert jerr is not None
        with pytest.raises(jerr):
            tengine.resolve_ring_chunk_rows(rows, impl)
    for impl in ("psum", "allgather_packed"):
        assert tengine.resolve_ring_chunk_rows(None, impl) is None
    assert tengine.resolve_ring_chunk_rows(256, "allgather_packed") == 256
    assert tcoll.DEFAULT_RING_CHUNK_ROWS == jcoll.DEFAULT_RING_CHUNK_ROWS
