"""The port's streamed (FSDP) trainer, ``repro_torch.train.step_streamed``,
against the JAX package's layout and ledgers and the port's simple step, on
the CPU at the smoke sizes (``tests/test_torch_streamed_jax.py`` holds the
step against JAX's streamed step itself):

(a) the shard axis of every leaf of the ten JAX registry configs (smoke and
    full) at 2, 4, 8 and 16 shards, from JAX's shapes and logical axes,
    equals ``repro.train.step_streamed.build_fsdp_layout``'s; the port's own
    models give the same axes and logical axes;
(b) ``wire_bytes_per_device`` and ``gather_hbm_bytes`` equal JAX's streamed
    ledger (its build-time sums, from JAX's wires and bucket plans) per leaf
    and bucketed, on every wire, ring and elastic variant;
(c) at M = 4 in one process the streamed step equals the simple step bit for
    bit, per leaf and bucketed (so bucketed equals per leaf), on every wire
    and mode and under elastic participation: two layers for the
    fixed-budget vote wires, one for the compressors whose budget or scale
    reads the whole leaf (qsgd8's L2, TernGrad's L-inf, a target sparsity)
    and for the EF server's L1 scale, which the streamed step takes over a
    layer and the simple step over the stacked leaf (at one repeat the two
    are one leaf); where they differ, bucketed still equals per leaf;
(d) the build-time refusals: tail blocks, tied embeddings, tau > 1.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.configs.registry import get_config as jget
from repro.core import engine as jengine
from repro.core.algorithm import CompressionConfig as JConfig
from repro.core.budgets import BudgetConfig as JBudget
from repro.dist import bucketing as jbuck
from repro.dist import collectives as jcoll
from repro.models.model import Model as JModel
from repro.train import step_streamed as jss
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import tree_leaves
from repro_torch.dist.collectives import ParticipationSpec, WorkerGroup
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models.model import Model
from repro_torch.train import step_streamed as tss
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step

ARCH = "llama4-scout-17b-a16e"
WEIGHTS = (1.5, 0.5, 2.0, 1.0)


def _batch(cfg, r: int, b: int = 4, s: int = 16) -> dict:
    """Global batch r: tokens (or N(0, 0.3^2) embeddings) and labels from
    numpy's seed r, positions 0..s-1, and for M-RoPE ``positions3``."""
    rng = np.random.RandomState(r)
    out = {"inputs": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "positions": np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()}
    if cfg.input_kind != "tokens":
        out["inputs"] = (rng.randn(b, s, cfg.d_model) * 0.3).astype(np.float32)
    if cfg.mrope:
        out["positions3"] = np.broadcast_to(out["positions"][..., None], (b, s, 3)).copy()
    return out


def _bits(t) -> np.ndarray:
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.int32)


# ------------------------------------------------------------ (a) shard axes

@pytest.mark.parametrize("n_shards", [2, 4, 8, 16])
def test_shard_axes_match_jax(n_shards):
    for arch in J_ARCH_IDS:
        for smoke in (True, False):
            jm = JModel(jget(arch, smoke=smoke))
            shapes, logical = jm.param_shapes(), jm.param_logical_axes()
            want = {}
            for k in shapes:
                min_axis = 1 if k == "blocks" else 0
                _, jaxes = jss.build_fsdp_layout(shapes[k], n_shards, "data",
                                                 min_axis=min_axis, logical_tree=logical[k])
                got = tss.build_fsdp_layout(shapes[k], n_shards, min_axis=min_axis,
                                            logical_tree=logical[k])
                want[k] = jax.tree_util.tree_leaves(jaxes)
                assert tree_leaves(got) == want[k], (arch, smoke, k)
            if arch not in ARCH_IDS:
                continue
            tm = Model(get_config(arch, smoke=smoke))
            lay = tss.streamed_layout(tm, WorkerGroup(("data",), (n_shards,)))
            assert {k: [x.axis for x in tree_leaves(lay[k])] for k in lay} == want, arch
            assert (tss._logical_leaves(tm.param_logical_axes())
                    == tss._logical_leaves(logical)), arch


def test_layout_slices_of_two_processes_tile_each_leaf():
    """Rank r of two processes holds shards 2r and 2r + 1 of a sharded leaf;
    a replicated leaf is whole on both."""
    tm = Model(get_config(ARCH, smoke=True))
    lays = [tree_leaves(tss.streamed_layout(tm, WorkerGroup(("data",), (4,), rank=r,
                                                             world=2)))
            for r in range(2)]
    for a, b in zip(*lays):
        if a.axis == tss.REPLICATED:
            assert a.whole and b.whole
            continue
        assert (a.start, b.start) == (0, a.size) and a.size + b.size == a.shape[a.axis]
        assert a.shard * 2 == a.size and not a.whole


# -------------------------------------------------------------- (b) ledgers

GOLOMB_P = 0.05
# case -> (compressor, server, vote_impl, budget kind, budget, ring, elastic)
LEDGER_CASES = {
    "psum": ("sparsign", "majority_vote", "psum", "fixed", 2.0, False, False),
    "hier": ("sparsign", "majority_vote", "hier", "fixed", 2.0, False, False),
    "pack2": ("sparsign", "majority_vote", "allgather_packed", "fixed", 2.0, False, False),
    "golomb": ("sparsign_golomb", "majority_vote", "allgather_packed", "target_sparsity",
               GOLOMB_P, False, False),
    "pack8": ("qsgd8", "mean", "allgather_packed", "fixed", 1.0, False, False),
    "scaled_votes": ("terngrad", "mean", "psum", "fixed", 1.0, False, False),
    "decoded": ("qsgd8", "mean", "psum", "fixed", 1.0, False, False),
    "ring_pack2": ("sparsign", "majority_vote", "allgather_packed", "fixed", 2.0, True, False),
    "ring_golomb": ("sparsign_golomb", "majority_vote", "allgather_packed", "target_sparsity",
                    GOLOMB_P, True, False),
    "ring_pack8": ("qsgd8", "mean", "allgather_packed", "fixed", 1.0, True, False),
    "elastic_psum": ("sparsign", "majority_vote", "psum", "fixed", 2.0, False, True),
    "elastic_pack2": ("sparsign", "majority_vote", "allgather_packed", "fixed", 2.0, False,
                      True),
    "elastic_pack8": ("qsgd8", "mean", "allgather_packed", "fixed", 1.0, False, True),
}
RING_ROWS = 32


def _jax_wire(jcomp, impl, mode, ring, part):
    fmt = jengine.wire_payload_format(jcomp, mode, vote_impl=impl)
    rows = RING_ROWS if ring else None
    if impl == "hier":
        return jcoll.HierVoteWire(axes=("pod", "data"), n_workers=4, inner_size=2,
                                  outer_size=2, participation=part)
    if fmt == "pack8":
        return jcoll.Pack8Wire(axes=("data",), n_workers=4, ring_chunk_rows=rows,
                               participation=part)
    if fmt == "golomb":
        return jcoll.GolombWire(axes=("data",), n_workers=4, p=GOLOMB_P, ring_chunk_rows=rows,
                                participation=part)
    if impl == "allgather_packed":
        return jcoll.PackedVoteWire(axes=("data",), n_workers=4, ring_chunk_rows=rows,
                                    participation=part)
    return jcoll.VoteWire(axes=("data",), n_workers=4, participation=part)


def _jax_streamed_ledger(jm, jcomp, impl, ring, part, bucketed):
    """(wire_bytes_per_device, gather_hbm_bytes) as JAX's
    ``build_streamed_train_step`` sums them at build time
    (``repro/train/step_streamed.py:239-288``), from JAX's wire and plans."""
    mode = jengine.wire_mode(jcomp, vote_impl=impl)
    wire = _jax_wire(jcomp, impl, mode, ring, part)
    share = jengine.needs_shared_linf(jcomp)
    shapes, n_rep = jm.param_shapes(), jm.cfg.n_repeats
    outer_keys = [k for k in shapes if k != "blocks"]
    blocks = jax.tree_util.tree_leaves(shapes["blocks"])

    def exchange_bytes(n):
        return jcoll.uplink_ledger(mode, wire, n, share_linf=share)

    ledger = sum(n_rep * exchange_bytes(math.prod(s.shape[1:])) for s in blocks)
    ledger += sum(exchange_bytes(math.prod(s.shape)) for k in outer_keys
                  for s in jax.tree_util.tree_leaves(shapes[k]))
    gather = 0.0
    if mode != "decoded":
        gather = max([wire.gather_hbm_bytes(math.prod(s.shape[1:])) for s in blocks]
                     + [wire.gather_hbm_bytes(math.prod(shapes[k].shape)) for k in outer_keys])
    if bucketed:
        fmt = jbuck.wire_bucket_format(mode, wire)
        rows_fn = wire.payload_rows if fmt == "golomb" else None
        bp = jbuck.build_bucket_plan([jax.ShapeDtypeStruct(s.shape[1:], s.dtype)
                                      for s in blocks], fmt, rows_fn=rows_fn)
        op = jbuck.build_bucket_plan([shapes[k] for k in outer_keys], fmt, rows_fn=rows_fn)
        pay, scal = jbuck.streamed_plan_ledger(mode, wire, bp, op, n_rep, share_linf=share)
        ledger = pay + scal
        gather = max(jbuck.plan_gather_hbm_bytes(mode, wire, bp),
                     jbuck.plan_gather_hbm_bytes(mode, wire, op))
    return ledger, gather


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("case", list(LEDGER_CASES))
def test_ledgers_match_jax(case, bucketed):
    compressor, server, impl, kind, value, ring, elastic = LEDGER_CASES[case]
    jm, tm = JModel(jget(ARCH, smoke=True)), Model(get_config(ARCH, smoke=True))
    jcomp = JConfig(compressor=compressor, budget=JBudget(kind=kind, value=value),
                    server=server)
    comp = CompressionConfig(compressor=compressor, budget=BudgetConfig(kind=kind, value=value),
                             server=server)
    jpart = jcoll.ParticipationSpec(q_frac=0.5) if elastic else None
    part = ParticipationSpec(q_frac=0.5) if elastic else None
    group = make_mesh((2, 2), ("pod", "data")) if impl == "hier" else make_host_mesh(4)
    step = tss.build_streamed_train_step(tm, tss.StreamedStepConfig(
        compression=comp, lr=LrSchedule(), vote_impl=impl, bucketed=bucketed,
        ring_chunk_rows=RING_ROWS if ring else None, participation=part), group)
    want = _jax_streamed_ledger(jm, jcomp, impl, ring, jpart, bucketed)
    assert step.ledger == want
    if case == "pack2":   # the metrics carry the ledger as float32
        state = init_state(tm.init(0, device="cpu"), server=server, seed=1)
        _, m = step(state, _batch(tm.cfg, 0))
        assert float(m["wire_bytes_per_device"]) == float(np.float32(want[0]))
        assert float(m["gather_hbm_bytes"]) == float(np.float32(want[1]))


# ------------------------------------------------- (c) streamed == simple

# case -> (compressor, server, vote_impl, budget, layers, streamed step's extra fields)
STEP_CASES = {
    "psum": ("sparsign", "majority_vote", "psum", 2.0, 2, {}),
    "hier": ("sparsign", "majority_vote", "hier", 2.0, 2, {}),
    "pack2": ("sparsign", "majority_vote", "allgather_packed", 2.0, 2, {}),
    # a layer's coded message has a layer's capacity: at a plan fraction the
    # density outruns, a layer's message truncates otherwise than the
    # stacked leaf's, so the plan fraction here leaves room (nothing drops)
    "golomb": ("sparsign_golomb", "majority_vote", "allgather_packed", 2.0, 2,
               {"golomb_p": 0.2}),
    "ring_pack2": ("sparsign", "majority_vote", "allgather_packed", 2.0, 2,
                   {"ring_chunk_rows": RING_ROWS}),
    "elastic_psum": ("sparsign", "majority_vote", "psum", 2.0, 2,
                     {"participation": ParticipationSpec(weights=WEIGHTS, dropout=0.25)}),
    "elastic_pack2": ("sparsign", "majority_vote", "allgather_packed", 2.0, 2,
                      {"participation": ParticipationSpec(weights=WEIGHTS, dropout=0.25)}),
    "pack8": ("qsgd8", "mean", "allgather_packed", 1.0, 1, {}),
    "elastic_pack8": ("qsgd8", "mean", "allgather_packed", 1.0, 1,
                      {"participation": ParticipationSpec(weights=WEIGHTS, dropout=0.25)}),
    "scaled_votes": ("terngrad", "mean", "psum", 1.0, 1, {}),
    "decoded": ("qsgd8", "mean", "psum", 1.0, 1, {}),
    "ef": ("sparsign", "scaled_sign_ef", "psum", 2.0, 1, {}),
}


def _run_step(model, comp, impl, kw, *, streamed, bucketed=False, steps=2, simple_kw=None):
    group = make_mesh((2, 2), ("pod", "data")) if impl == "hier" else make_host_mesh(4)
    lr = LrSchedule(base=0.05)
    if streamed:
        step = tss.build_streamed_train_step(model, tss.StreamedStepConfig(
            compression=comp, lr=lr, vote_impl=impl, bucketed=bucketed, **kw), group)
    else:
        step = build_train_step(model, TrainStepConfig(
            compression=comp, lr=lr, vote_impl=impl, **(simple_kw or kw)), group)
    state = init_state(model.init(0, device="cpu"), server=comp.server, seed=3)
    for r in range(steps):
        state, m = step(state, _batch(model.cfg, r))
    leaves = tree_leaves(state.params) + (tree_leaves(state.ef_residual)
                                          if state.ef_residual is not None else [])
    return [_bits(t) for t in leaves], {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_streamed_equals_simple_bit_for_bit(case):
    """One step a case (the 2-bit wire's two: the second from the state the
    first wrote in place)."""
    compressor, server, impl, value, layers, kw = STEP_CASES[case]
    arch = "qwen2-vl-72b" if case in ("hier", "decoded") else ARCH
    cfg = dataclasses.replace(get_config(arch, smoke=True), n_layers=layers)
    model = Model(cfg)
    comp = CompressionConfig(compressor=compressor, budget=BudgetConfig(value=value),
                             server=server)
    steps = 2 if case == "pack2" else 1
    ref, ref_m = _run_step(model, comp, impl, kw, streamed=False, steps=steps)
    for bucketed in (False, True):
        got, m = _run_step(model, comp, impl, kw, streamed=True, bucketed=bucketed,
                           steps=steps)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        for k in ("loss", "nnz_frac", "participated", "lr"):
            assert m[k] == ref_m[k], (bucketed, k)
        assert m.get("nnz_dropped", 0.0) == 0.0


@pytest.mark.parametrize("case", ["golomb_target_sparsity", "ef"])
def test_bucketed_equals_per_leaf_where_simple_differs(case):
    """Two layers: a target sparsity solved a layer, the EF scale a layer;
    the double-buffered bucketed step is the per-leaf one rescheduled."""
    model = Model(get_config(ARCH, smoke=True))
    if case == "ef":
        comp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                                 server="scaled_sign_ef")
        impl = "allgather_packed"
    else:
        comp = CompressionConfig(compressor="sparsign_golomb", budget=BudgetConfig(
            kind="target_sparsity", value=GOLOMB_P), server="majority_vote")
        impl = "allgather_packed"
    steps = 2 if case == "ef" else 1   # the EF residual carried into a second step
    ref, ref_m = _run_step(model, comp, impl, {}, streamed=True, steps=steps)
    got, m = _run_step(model, comp, impl, {}, streamed=True, bucketed=True, steps=steps)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert (m["loss"], m["nnz_frac"]) == (ref_m["loss"], ref_m["nnz_frac"])
    assert all(np.isfinite(a.view(np.float32)).all() for a in got)


# --------------------------------------------------------- (d) refusals

def test_build_time_refusals():
    cfg = get_config(ARCH, smoke=True)
    comp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                             server="majority_vote")
    group = make_host_mesh(2)

    def build(cfg_, comp_=comp):
        return tss.build_streamed_train_step(Model(cfg_), tss.StreamedStepConfig(
            compression=comp_, lr=LrSchedule()), group)

    build(cfg)
    with pytest.raises(ValueError, match="tail blocks"):
        build(get_config("gemma3-27b", smoke=True))
    with pytest.raises(ValueError, match="untied embeddings"):
        build(dataclasses.replace(cfg, tie_embeddings=True))
    with pytest.raises(ValueError, match="tau = 2"):
        build(cfg, dataclasses.replace(comp, local_steps=2))
    with pytest.raises(ValueError, match="scaled_sign_ef"):
        build(cfg, dataclasses.replace(comp, server="scaled_sign_ef", compressor="qsgd8"))
