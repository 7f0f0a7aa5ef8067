"""The port's bucketed uplink (``repro_torch.dist.bucketing``) against the
JAX package's, on the CPU:

(a) bucket plans slot for slot, for every payload format, with and without
    a ``bucket_bytes`` cap, golomb sized by its wire's capacity rows;
(b) ``as_rows``, ``assemble_bucket`` and ``split_bucket`` byte for byte;
(c) ``plan_ledger``, ``uplink_ledger_bucket`` and ``plan_gather_hbm_bytes``
    (and the per-leaf ledgers beside them) for M = 1, 2, 4 and 8, elastic or
    not, ring or not, from JAX's wires built directly;
(d) the port's bucketed step against its per-leaf step at M = 4, bit for
    bit, with equal metrics, on every wire mode (two rounds of injected
    gradients, one bucket and capped buckets).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import bucketing as jbuck
from repro.dist import collectives as jcoll
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import tree_leaves
from repro_torch.dist import bucketing as tbuck
from repro_torch.dist import collectives as tcoll
from repro_torch.dist.collectives import ParticipationSpec, WorkerGroup
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import params_from_numpy
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step

from test_torch_train import M, InjectedModel, _injected, f32bits

# JAX's tests/test_bucketing.py shapes, and larger ones the golomb capacity
# rule accepts at p = 0.05
ODD_SHAPES = [(33,), (7, 129), (2, 3, 85), (513,), (64, 511)]
GOLOMB_SHAPES = [(64, 511), (40000,), (3, 4096), (9000,)]
GOLOMB_P = 0.05
CAPS = [None, 4096, 1 << 14]


def _jax_shapes(shapes):
    return [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]


def _slots(plan):
    return [(tuple((s.index, s.size, tuple(s.shape), s.row_start, s.rows) for s in b.slots),
             b.rows) for b in plan.buckets]


def _plans(fmt, cap):
    shapes = GOLOMB_SHAPES if fmt == "golomb" else ODD_SHAPES
    jrows = trows = None
    if fmt == "golomb":
        jrows = jcoll.GolombWire(axes=("data",), n_workers=4, p=GOLOMB_P).payload_rows
        trows = tcoll.GolombWire(group=WorkerGroup(("data",), (4,)), n_workers=4,
                                 p=GOLOMB_P).payload_rows
    jp = jbuck.build_bucket_plan(_jax_shapes(shapes), fmt, bucket_bytes=cap, rows_fn=jrows)
    tp = tbuck.build_bucket_plan(shapes, fmt, bucket_bytes=cap, rows_fn=trows)
    return shapes, jp, tp


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("fmt", list(tbuck.BUCKET_FORMATS))
def test_plan_matches_jax(fmt, cap):
    _, jp, tp = _plans(fmt, cap)
    assert (tp.fmt, tp.align_rows) == (jp.fmt, jp.align_rows)
    assert _slots(tp) == _slots(jp)
    assert (tp.n_slots, tp.total_rows, tp.wire_nbytes()) == (jp.n_slots, jp.total_rows,
                                                              jp.wire_nbytes())
    assert [b.n_coords for b in tp.buckets] == [b.n_coords for b in jp.buckets]
    if cap == 4096:
        assert len(tp.buckets) > 1
    assert tbuck.ROW_BYTES == jbuck.ROW_BYTES and tbuck.ROW_WIDTH == jbuck.ROW_WIDTH
    assert tbuck.format_align_rows(fmt) == jbuck.format_align_rows(fmt)


def test_plan_refusals_match_jax():
    for fmt, rows_fn in (("golomb", None), ("pack2", lambda n: 1), ("nope", None)):
        with pytest.raises(ValueError):
            jbuck.build_bucket_plan(_jax_shapes(ODD_SHAPES), fmt, rows_fn=rows_fn)
        with pytest.raises(ValueError):
            tbuck.build_bucket_plan(ODD_SHAPES, fmt, rows_fn=rows_fn)


def _message(fmt, shape, rows, rng):
    """A random message in ``fmt``'s per-leaf layout, as numpy."""
    n = int(np.prod(shape))
    width = tbuck.ROW_WIDTH[fmt]
    if fmt == "golomb":
        return rng.randint(0, 256, (rows, width)).astype(np.uint8)
    if fmt in ("pack2", "pack8"):
        canon = -(-(-(-n // 512)) // 32) * 32
        dt = np.uint8 if fmt == "pack2" else np.int8
        return rng.randint(0, 256, (canon, width)).astype(np.uint8).view(dt)
    if fmt == "int8":
        return rng.randint(-1, 2, shape).astype(np.int8)
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("fmt", list(tbuck.BUCKET_FORMATS))
def test_rows_assemble_and_split_match_jax(fmt):
    shapes, jp, tp = _plans(fmt, 4096)
    rng = np.random.RandomState(1)
    for jb, tb in zip(jp.buckets, tp.buckets):
        jparts, tparts = [], []
        for s in tb.slots:
            msg = _message(fmt, shapes[s.index], s.rows, rng)
            j = np.asarray(jbuck.as_rows(jnp.asarray(msg), fmt, s.rows))
            t = tbuck.as_rows(torch.from_numpy(msg), fmt, s.rows)
            np.testing.assert_array_equal(t.numpy(), j)
            jparts.append(jnp.asarray(j))
            tparts.append(t)
        jbuf = np.asarray(jbuck.assemble_bucket(jparts, jb, fmt))
        tbuf = tbuck.assemble_bucket(tparts, tb, fmt)
        assert tbuf.dtype == {"int8": torch.int8, "pack2": torch.uint8, "golomb": torch.uint8,
                              "pack8": torch.int8, "f32": torch.float32}[fmt]
        np.testing.assert_array_equal(tbuf.numpy(), jbuf)
        if fmt == "golomb":   # capacity rows: decoded per slot, never split
            continue
        agg = rng.randn(tb.rows, 512).astype(np.float32)
        for a, b in zip(tbuck.split_bucket(torch.from_numpy(agg), tb),
                        jbuck.split_bucket(jnp.asarray(agg), jb)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _wire_pair(kind, m, part, ring):
    """The same wire in both packages: JAX's built directly, as
    tests/test_ring.py builds them."""
    jpart = jcoll.ParticipationSpec(weights=part) if part else None
    tpart = ParticipationSpec(weights=part) if part else None
    group = WorkerGroup(("data",), (m,))
    if kind == "hier":
        outer = 2 if m % 2 == 0 and m > 2 else 1
        inner = m // outer
        return (jcoll.HierVoteWire(axes=("pod", "data"), n_workers=m, inner_size=inner,
                                   outer_size=outer, participation=jpart),
                tcoll.HierVoteWire(group=WorkerGroup(("pod", "data"), (outer, inner)),
                                   n_workers=m, inner_size=inner, outer_size=outer,
                                   participation=tpart))
    if kind == "psum":
        return (jcoll.VoteWire(axes=("data",), n_workers=m, participation=jpart),
                tcoll.VoteWire(group=group, n_workers=m, participation=tpart))
    cls = {"pack2": ("PackedVoteWire", {}), "golomb": ("GolombWire", {"p": GOLOMB_P}),
           "pack8": ("Pack8Wire", {})}[kind]
    return (getattr(jcoll, cls[0])(axes=("data",), n_workers=m, ring_chunk_rows=ring,
                                   participation=jpart, **cls[1]),
            getattr(tcoll, cls[0])(group=group, n_workers=m, ring_chunk_rows=ring,
                                   participation=tpart, **cls[1]))


# (wire, mode, share_linf): every mode a bucket can carry
LEDGER_CASES = [("psum", "votes", False), ("hier", "votes", False), ("pack2", "votes", False),
                ("pack2", "scaled_votes", True), ("golomb", "votes", False),
                ("pack8", "pack8", False), ("pack2", "decoded", False),
                ("psum", "decoded", True)]


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_ledgers_match_jax(m):
    for kind, mode, share in LEDGER_CASES:
        for elastic in (False, True):
            for ring in ((None, 32, 256) if kind in ("pack2", "golomb", "pack8") else (None,)):
                part = tuple(0.5 + 0.25 * k for k in range(m)) if elastic else None
                jw, tw = _wire_pair(kind, m, part, ring)
                fmt = tbuck.wire_bucket_format(mode, tw)
                assert fmt == jbuck.wire_bucket_format(mode, jw)
                for cap in (None, 1 << 15):
                    _, jp, tp = _plans(fmt, cap)
                    label = (kind, mode, elastic, ring, cap)
                    assert (tbuck.plan_ledger(mode, tw, tp, share_linf=share)
                            == jbuck.plan_ledger(mode, jw, jp, share_linf=share)), label
                    assert (tbuck.plan_gather_hbm_bytes(mode, tw, tp)
                            == jbuck.plan_gather_hbm_bytes(mode, jw, jp)), label
                    for jb, tb in zip(jp.buckets, tp.buckets):
                        args = (mode, tb.n_coords, len(tb.slots))
                        kw = dict(rows=tb.rows, ring_chunks=tw.bucket_ring_chunks(tb))
                        assert tw.bucket_ring_chunks(tb) == jw.bucket_ring_chunks(jb), label
                        assert (tcoll.uplink_ledger_bucket(args[0], tw, *args[1:], **kw)
                                == jcoll.uplink_ledger_bucket(args[0], jw, *args[1:], **kw))
                for shape in (GOLOMB_SHAPES if fmt == "golomb" else ODD_SHAPES):
                    n = int(np.prod(shape))
                    assert (tcoll.uplink_ledger(mode, tw, n, share_linf=share)
                            == jcoll.uplink_ledger(mode, jw, n, share_linf=share)), label
                    assert tw.ring_chunks(n) == jw.ring_chunks(n)
                    assert tw.gather_hbm_bytes(n) == jw.gather_hbm_bytes(n)


# mode label -> (compressor, budget, server, vote_impl, elastic); the mesh is
# 2 x 2 for hier, else four workers on one axis
STEP_CASES = {
    "psum": ("sparsign", 2.0, "majority_vote", "psum", False),
    "hier": ("sparsign", 2.0, "majority_vote", "hier", False),
    "pack2": ("sparsign", 2.0, "majority_vote", "allgather_packed", False),
    "golomb": ("sparsign_golomb", 0.5, "majority_vote", "allgather_packed", False),
    "pack8": ("qsgd8", 1.0, "mean", "allgather_packed", False),
    "decoded": ("qsgd8", 1.0, "mean", "psum", False),
    "scaled_votes": ("terngrad", 1.0, "mean", "allgather_packed", False),
    "ef": ("sparsign", 2.0, "scaled_sign_ef", "allgather_packed", False),
    "elastic_psum": ("sparsign", 2.0, "majority_vote", "psum", True),
    "elastic_hier": ("sparsign", 2.0, "majority_vote", "hier", True),
    "elastic_pack2": ("sparsign", 2.0, "majority_vote", "allgather_packed", True),
    "elastic_golomb": ("sparsign_golomb", 0.5, "majority_vote", "allgather_packed", True),
    "elastic_pack8": ("qsgd8", 1.0, "mean", "allgather_packed", True),
    "elastic_decoded": ("qsgd8", 1.0, "mean", "psum", True),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_bucketed_step_equals_the_per_leaf_step(case):
    """Two rounds at M = 4 with injected gradients: the bucketed step (one
    bucket, and buckets capped at 2 KiB) gives the per-leaf step's
    parameters and metrics bit for bit."""
    name, budget, server, impl, elastic = STEP_CASES[case]
    comp = CompressionConfig(compressor=name, budget=BudgetConfig(value=budget), server=server)
    part = ParticipationSpec(weights=(1.5, 0.5, 2.0, 1.0), dropout=0.25) if elastic else None
    group = make_mesh((2, 2), ("pod", "data")) if impl == "hier" else make_mesh((M,), ("data",))
    params, _, _ = _injected(0)
    results = {}
    for label, kw in (("leaf", {}), ("one bucket", {"bucketed": True}),
                      ("capped", {"bucketed": True, "bucket_bytes": 2048})):
        step = build_train_step(InjectedModel(), TrainStepConfig(
            compression=comp, lr=LrSchedule(base=0.05), vote_impl=impl, participation=part,
            golomb_p=0.3 if name == "sparsign_golomb" else None, **kw), group)
        if label == "capped":
            assert len(step.plan.buckets) > 1
        state = init_state(params_from_numpy({"blocks": ({"a": params[0], "b": params[1]},),
                                              "embed": params[2], "final_norm": params[3]}),
                           server=server, seed=11)
        mets = []
        for r in range(2):
            state, metrics = step(state, _injected(r + 1)[2])
            mets.append({k: float(v) for k, v in metrics.items()
                         if k not in ("wire_bytes_per_device", "gather_hbm_bytes")})
        leaves = [t.numpy().copy() for t in tree_leaves(state.params)]
        efs = ([t.numpy().copy() for t in tree_leaves(state.ef_residual)]
               if state.ef_residual is not None else [])
        results[label] = (leaves, efs, mets)
    ref = results["leaf"]
    assert any((a != p).any() for a, p in zip(ref[0], params)), "the rounds must move"
    for label, (leaves, efs, mets) in results.items():
        for a, b in zip(leaves + efs, ref[0] + ref[1]):
            np.testing.assert_array_equal(f32bits(a), f32bits(b), err_msg=label)
        assert mets == ref[2], label
