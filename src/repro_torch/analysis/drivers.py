"""Drivers of the port's analysis gate and its tests, the counterparts of the
drivers of ``repro.analysis.drivers`` that need no jaxpr: tiny-model steps
run with the collective recorder open, pinned against the VoteWire ledger;
launch-count budgets; the elastic censuses; the entropy-wire and ring
ledger floors; and the fused wire ops against their plain chains.

One definition serves ``python -m repro_torch.analysis`` and
``tests/test_torch_analysis.py``, so the gate and the tests hold the SAME
runs.

JAX traces its step on one device and costs the trace at a hypothetical
``HYPOTHETICAL_M`` = 16 workers. The port runs the step for real: M = 16
workers in one process (``WorkerGroup(("data",), (16,))``, each worker
one row of a 16-row batch), whose recorder notes every wrapper call with
its operand, a worker's share, at M = 16 (nothing moves between processes,
and the byte model is the one a 16-process group would pay). M <= 127 keeps
the int8 vote-sum dtype. The steps run on the card by default, or on the
CPU (``device="cpu"``) with the plain versions; either way every wire
gathers what it ships (no wire of the port skips its exchange).

A float sum the port runs as a gather added up in worker order
(``collectives.ordered_psum``: the decoded wire, the elastic psum wires'
weighted votes and per-coordinate W) is billed as the all-reduce of JAX's
program, as the ledger bills it; between processes that gather moves
(M - 1) x in, not 2(M - 1)/M x in. The census and elastic passes each add
one note with those setups' moved bytes beside the ledger's.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.analysis.rules import (CollectiveCensus, CollectiveCountBudget,
                                        EntropyWireBudget, FusedEqualsPlain, FusedOneLaunch,
                                        GatherHbmBudget, MaskedPayloadZero)
from repro_torch.core.compressors import tree_leaves
from repro_torch.dist import bucketing, collectives

#: the worker count the steps run at: > 1 so every ring term is non-vacuous,
#: <= 127 so the int8 vote-sum dtype holds (JAX's HYPOTHETICAL_M)
HYPOTHETICAL_M = 16

#: plan-time nonzero fraction of the golomb setups, also their target_sparsity
GOLOMB_P = 0.05

#: report dropout of the elastic setups: at M = 16 and the setups' seed, eight
#: workers' reports drop in the census round (MaskedPayloadZero needs some)
ELASTIC_DROPOUT = 0.25

#: wire setup -> (compressor, server, vote_impl, budget), JAX's table
MODE_SETUPS = {
    "votes": ("sparsign", "majority_vote", "psum", 2.0),
    "scaled_votes": ("terngrad", "mean", "psum", 1.0),
    "pack8": ("qsgd8", "mean", "allgather_packed", 1.0),
    "decoded": ("qsgd8", "mean", "psum", 1.0),
    "golomb": ("sparsign_golomb", "majority_vote", "allgather_packed", GOLOMB_P),
}

#: payload rows a ring chunk: one sublane tile, so the tiny model's buckets
#: split into many chunks (JAX's value)
RING_SWEEP_CHUNK_ROWS = 32

#: ring setups: the three gather wires over the chunked ring
RING_SETUPS = {
    "ring_pack2": ("sparsign", "majority_vote", "allgather_packed", 2.0),
    "ring_pack8": ("qsgd8", "mean", "allgather_packed", 1.0),
    "ring_golomb": ("sparsign_golomb", "majority_vote", "allgather_packed", GOLOMB_P),
}

#: stacked-block configs the launch-ratio, entropy and ring floors read
RATIO_CONFIGS = ("qwen1.5-4b", "qwen2.5-32b", "qwen2-moe-a2.7b")
MIN_COUNT_RATIO = 5.0
MIN_ENTROPY_RATIO = 2.0

STEP_SEED = 7   # the TrainState seed of every setup's step


def _setup_of(mode: str) -> tuple:
    return MODE_SETUPS[mode] if mode in MODE_SETUPS else RING_SETUPS[mode]


def wire_mode_of(mode: str) -> str:
    """The engine wire mode a setup resolves to: the golomb and ring setups
    ride the votes and pack8 modes."""
    if mode.endswith("golomb") or mode == "ring_pack2":
        return "votes"
    if mode == "ring_pack8":
        return "pack8"
    return mode


def tiny_model():
    from repro_torch.configs.base import LayerSpec, ModelConfig
    from repro_torch.models.model import Model
    cfg = ModelConfig(name="analysis-tiny", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                      pattern=(LayerSpec(mixer="attn"),), dtype="float32", attn_chunk=8,
                      q_chunk=8, loss_chunk=8, remat=False)
    return Model(cfg)


def tiny_moe_model():
    """The tiny model with routed experts (3 real, padded to 4: model rank 1
    of two holds the null one) and a shared expert."""
    from repro_torch.configs.base import LayerSpec, ModelConfig
    from repro_torch.models.model import Model
    cfg = ModelConfig(name="analysis-tiny-moe", family="moe", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=16, vocab_size=64,
                      pattern=(LayerSpec(mixer="attn", moe=True),), n_experts=3,
                      n_experts_padded=4, top_k=2, moe_d_ff=16, n_shared_experts=1,
                      capacity_factor=2.0, dtype="float32", attn_chunk=8, q_chunk=8,
                      loss_chunk=8, remat=False)
    return Model(cfg)


def tiny_mamba_model():
    """A tiny mamba2 stack: mixer-only blocks of 4 heads, tied embeddings."""
    from repro_torch.configs.base import LayerSpec, ModelConfig
    from repro_torch.models.model import Model
    cfg = ModelConfig(name="analysis-tiny-mamba2", family="ssm", n_layers=2, d_model=32,
                      n_heads=1, n_kv_heads=1, d_ff=0, vocab_size=64,
                      pattern=(LayerSpec(mixer="mamba", ffn=False),), ssm_state=8,
                      ssm_head_dim=16, ssm_chunk=4, tie_embeddings=True, dtype="float32",
                      loss_chunk=8, remat=False)
    return Model(cfg)


def tiny_batch(vocab: int, b: int, s: int = 8, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randint(0, vocab, (b, s)).astype(np.int32),
            "labels": rng.randint(0, vocab, (b, s)).astype(np.int32),
            "positions": np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()}


def mode_comp(mode: str):
    from repro_torch.core.algorithm import CompressionConfig
    from repro_torch.core.budgets import BudgetConfig
    compressor, server, _, budget = _setup_of(mode)
    kind = "target_sparsity" if mode.endswith("golomb") else "fixed"
    return CompressionConfig(compressor=compressor, budget=BudgetConfig(kind=kind, value=budget),
                             server=server)


def participation_spec():
    return collectives.ParticipationSpec(q_frac=0.5, dropout=ELASTIC_DROPOUT)


def _group(m: int):
    return collectives.WorkerGroup(axes=("data",), sizes=(m,))


def mode_wire(mode: str, m: int, *, elastic: bool = False):
    """A costing wire of ``mode`` at ``m`` workers (the ring setups' with the
    sweep chunk size)."""
    part = participation_spec() if elastic else None
    rcr = RING_SWEEP_CHUNK_ROWS if mode in RING_SETUPS else None
    kw = dict(group=_group(m), n_workers=m, participation=part)
    if mode in ("pack8", "ring_pack8"):
        return collectives.Pack8Wire(ring_chunk_rows=rcr, **kw)
    if mode.endswith("golomb"):
        return collectives.GolombWire(p=GOLOMB_P, ring_chunk_rows=rcr, **kw)
    if mode == "ring_pack2":
        return collectives.PackedVoteWire(ring_chunk_rows=rcr, **kw)
    return collectives.VoteWire(**kw)


def _leaf_sizes(model) -> list:
    return [math.prod(s.shape) for s in tree_leaves(model.param_shapes())]


def dropped_workers(m: int) -> list:
    """The flat indices of the workers whose report the elastic setups'
    census round drops."""
    from repro_torch.train import sampling
    widx = torch.arange(m, dtype=torch.int64)
    rseed = sampling.round_seed(STEP_SEED, 0)
    keep = sampling.report_mask(rseed, 0, widx, ELASTIC_DROPOUT)
    return [int(w) for w in widx[~keep]]


@functools.lru_cache(maxsize=None)
def run_mode_step(mode: str, m: int = HYPOTHETICAL_M, device: str = "cuda", *,
                  bucketed: bool = False, elastic: bool = False):
    """One step of the tiny model's ``simple`` trainer whose wire resolves
    to ``mode``, at ``m`` workers in one process on ``device``, with the
    collective recorder open. Returns (census, model, metrics)."""
    from repro_torch.core import engine
    from repro_torch.train.state import LrSchedule, init_state
    from repro_torch.train.step_simple import TrainStepConfig, build_train_step

    _, server, vote_impl, _ = _setup_of(mode)
    comp = mode_comp(mode)
    resolved = engine.wire_mode(comp, vote_impl=vote_impl)
    assert resolved == wire_mode_of(mode), (mode, resolved)
    if mode.endswith("golomb"):
        assert engine.wire_payload_format(comp, resolved, vote_impl=vote_impl) == "golomb"
    model = tiny_model()
    step = build_train_step(model, TrainStepConfig(
        compression=comp, lr=LrSchedule(base=0.05), vote_impl=vote_impl, bucketed=bucketed,
        ring_chunk_rows=RING_SWEEP_CHUNK_ROWS if mode in RING_SETUPS else None,
        participation=participation_spec() if elastic else None), _group(m))
    state = init_state(model.init(0, device), server=server, seed=STEP_SEED)
    with collectives.record_collectives() as census:
        _, metrics = step(state, tiny_batch(model.cfg.vocab_size, b=m))
    return census, model, {k: float(v) for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# Ledgers, split the census way (array payloads, protocol scalars)
# ---------------------------------------------------------------------------

def mode_ledger(mode: str, model, m: int) -> tuple:
    """(payload, scalar) bytes the VoteWire ledger bills for one round of
    ``model`` at ``m`` workers, per leaf; re-sums to ``uplink_ledger``."""
    from repro_torch.core import engine
    share = engine.needs_shared_linf(mode_comp(mode))
    wire, emode = mode_wire(mode, m), wire_mode_of(mode)
    payload = scalar = 0.0
    for n in _leaf_sizes(model):
        p = (collectives.decoded_wire_bytes(n, m) if mode == "decoded" else wire.wire_bytes(n))
        sc = ((wire.scalar_bytes() * wire.ring_chunks(n) if emode == "pack8" else 0.0)
              + (collectives.allreduce_scalar_bytes(m) if share else 0.0))
        assert abs((p + sc) - collectives.uplink_ledger(emode, wire, n, share_linf=share)) < 1e-6
        payload += p
        scalar += sc
    return payload, scalar


def mode_bucket_plan(mode: str, model, m: int, bucket_bytes=None):
    wire = mode_wire(mode, m)
    fmt = bucketing.wire_bucket_format(wire_mode_of(mode), wire)
    return bucketing.build_bucket_plan(tree_leaves(model.param_shapes()), fmt,
                                       bucket_bytes=bucket_bytes,
                                       rows_fn=(wire.payload_rows if fmt == "golomb" else None))


def mode_bucketed_ledger(mode: str, model, m: int, bucket_bytes=None, *,
                         elastic: bool = False) -> tuple:
    """(payload, scalar, plan) of the bucketed step: the plan's ledger
    (``bucketing.plan_ledger``), elastic or not."""
    from repro_torch.core import engine
    share = engine.needs_shared_linf(mode_comp(mode))
    wire = mode_wire(mode, m, elastic=elastic)
    plan = mode_bucket_plan(mode, model, m, bucket_bytes)
    payload, scalar = bucketing.plan_ledger(wire_mode_of(mode), wire, plan, share_linf=share)
    return payload, scalar, plan


def elastic_mode_ledger(mode: str, model, m: int) -> tuple:
    """(payload, scalar) of the per-leaf ELASTIC step, ``uplink_ledger``
    re-summed the census way: the psum wires' per-coordinate W is a second
    float32 payload (inside ``wire_bytes``), pack8's (2,) side vector a
    payload, the ternary gather wires' (1,) weight a scalar."""
    from repro_torch.core import engine
    share = engine.needs_shared_linf(mode_comp(mode))
    wire, emode = mode_wire(mode, m, elastic=True), wire_mode_of(mode)
    payload = scalar = 0.0
    for n in _leaf_sizes(model):
        p = (collectives.decoded_wire_bytes(n, m) if mode == "decoded" else wire.wire_bytes(n))
        sc = 0.0
        if emode == "pack8":
            p += wire.scalar_bytes() * wire.ring_chunks(n)
        elif mode != "decoded":
            sc += wire.weight_bytes() * wire.ring_chunks(n)
        if share:
            sc += collectives.allreduce_scalar_bytes(m)
        assert abs((p + sc) - collectives.uplink_ledger(emode, wire, n, share_linf=share)) < 1e-6
        payload += p
        scalar += sc
    return payload, scalar


# ---------------------------------------------------------------------------
# The census and count checks
# ---------------------------------------------------------------------------

def _label(mode: str, bucketed: bool, elastic: bool = False) -> str:
    return f"step[{mode}{'/bucketed' if bucketed else ''}{'/elastic' if elastic else ''}]"


def moved_note(rule, where: str, rows: list) -> list:
    """One note over ``rows`` ((label, census) pairs): the setups whose
    billed sums run as worker-order gathers, and the bytes those move
    between processes beside the ledger's bill."""
    rows = [(label, c) for label, c in rows
            if any(r.role == "wire" and r.moved for r in c.records)]
    if not rows:
        return []
    moved = sum(c.moved_bytes() for _, c in rows)
    billed = sum(c.payload_bytes() + c.scalar_bytes() for _, c in rows)
    return [rule.finding(
        where, f"{len(rows)} setups sum floats as worker-order gathers "
               f"({', '.join(label for label, _ in rows)}): between processes they move "
               f"{moved:.1f} B where the ledger bills {billed:.1f} B", severity="info")]


def census_check(mode: str, m: int = HYPOTHETICAL_M, device: str = "cuda", *,
                 bucketed: bool = False) -> tuple:
    """Recorded payload bytes == the ledger's, billed scalars == its protocol
    scalars. Returns (findings, census, ledger_payload, ledger_scalar)."""
    census, model, _ = run_mode_step(mode, m, device, bucketed=bucketed)
    if bucketed:
        payload, scalar, _ = mode_bucketed_ledger(mode, model, m)
    else:
        payload, scalar = mode_ledger(mode, model, m)
    findings = CollectiveCensus().check(_label(mode, bucketed), census,
                                        ledger_payload=payload, ledger_scalar=scalar)
    return findings, census, payload, scalar


def run_census_checks(m: int = HYPOTHETICAL_M, device: str = "cuda") -> tuple:
    findings, checks, rows = [], 0, []
    for mode in list(MODE_SETUPS) + list(RING_SETUPS):
        for bucketed in (False, True):
            f, census, _, _ = census_check(mode, m, device, bucketed=bucketed)
            findings += f
            rows.append((_label(mode, bucketed), census))
            checks += 1
    return findings + moved_note(CollectiveCensus(), "census", rows), checks


#: the tensor-parallel censuses: a (TP_M, TP_T) ('data', 'model') mesh in one
#: process. Setup -> (the wire setup whose compression it runs, vote_impl,
#: elastic, step options): fixed-budget sparsign with majority vote on psum
#: and on the 2-bit gather, sparsign_golomb under target_sparsity on the
#: Golomb gather (a slice's capacity: its whole leaf's nonzeros), the elastic
#: 2-bit gather; the bucketed uplink over the slice plan on the 2-bit and
#: Golomb gathers, the per-leaf 2-bit ring, and the bucketed Golomb and pack8
#: rings; the 2-bit gather on the tiny MoE model (experts on 'model') and the
#: tiny mamba2 model (its mixer split by heads); the streamed (FSDP) trainer
#: (``streamed`` in the options) on llama4-scout's smoke model, per leaf on
#: psum and the 2-bit gather and bucketed on the Golomb gather. ``TP_MODELS``
#: names a setup's model where it is not ``tiny_model``
TP_M, TP_T = 4, 2
TP_SETUPS = {
    "psum": ("votes", "psum", False, {}),
    "allgather_packed": ("votes", "allgather_packed", False, {}),
    "golomb": ("golomb", "allgather_packed", False, {}),
    "elastic": ("votes", "allgather_packed", True, {}),
    "bucketed": ("votes", "allgather_packed", False, {"bucketed": True}),
    "bucketed_golomb": ("golomb", "allgather_packed", False, {"bucketed": True}),
    "ring": ("votes", "allgather_packed", False, {"ring_chunk_rows": RING_SWEEP_CHUNK_ROWS}),
    "ring_bucketed_golomb": ("golomb", "allgather_packed", False,
                             {"bucketed": True, "ring_chunk_rows": RING_SWEEP_CHUNK_ROWS}),
    "ring_bucketed_pack8": ("pack8", "allgather_packed", False,
                            {"bucketed": True, "ring_chunk_rows": RING_SWEEP_CHUNK_ROWS}),
    "moe": ("votes", "allgather_packed", False, {}),
    "mamba2": ("votes", "allgather_packed", False, {}),
    "streamed_psum": ("votes", "psum", False, {"streamed": True}),
    "streamed_allgather_packed": ("votes", "allgather_packed", False, {"streamed": True}),
    "streamed_bucketed_golomb": ("golomb", "allgather_packed", False,
                                 {"streamed": True, "bucketed": True}),
}


def streamed_tiny_model():
    """llama4-scout-17b-a16e's smoke model: the streamed trainer's MoE
    pattern with the sigmoid top-1 router, at 2 layers."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    return Model(get_config("llama4-scout-17b-a16e", smoke=True))


TP_MODELS = {"moe": tiny_moe_model, "mamba2": tiny_mamba_model,
             "streamed_psum": streamed_tiny_model,
             "streamed_allgather_packed": streamed_tiny_model,
             "streamed_bucketed_golomb": streamed_tiny_model}


@functools.lru_cache(maxsize=None)
def run_tp_step(setup: str, device: str = "cuda"):
    """One step of the tiny model at (TP_M workers, TP_T model ranks) with the
    recorder open, a ``TP_SETUPS`` setup. Returns (census, model, step)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.state import LrSchedule, init_state
    from repro_torch.train.step_simple import TrainStepConfig, build_train_step
    from repro_torch.train.step_streamed import StreamedStepConfig, build_streamed_train_step

    mode, vote_impl, elastic, options = TP_SETUPS[setup]
    options = dict(options)
    model = TP_MODELS.get(setup, tiny_model)()
    group = make_mesh((TP_M, TP_T), ("data", "model"))
    kw = dict(compression=mode_comp(mode), lr=LrSchedule(base=0.05), vote_impl=vote_impl,
              participation=participation_spec() if elastic else None)
    if options.pop("streamed", False):
        step = build_streamed_train_step(model, StreamedStepConfig(**kw, **options), group)
    else:
        step = build_train_step(model, TrainStepConfig(**kw, **options), group)
    state = step.shard_state(init_state(model.init(0, device), server="majority_vote",
                                        seed=STEP_SEED))
    with collectives.record_collectives() as census:
        step(state, tiny_batch(model.cfg.vocab_size, b=TP_M))
    return census, model, step


def _slice_split(step, n: int, parts: int) -> tuple:
    """(payload, scalar) of one exchange of a leaf of n coordinates, cut into
    ``parts`` model slices (1: whole), as the census splits it."""
    wire = step.wire.for_slice(n) if parts > 1 else step.wire
    n_dev = n // parts
    total = collectives.uplink_ledger(step.mode, wire, n_dev, share_linf=step.share_linf)
    chunks = wire.ring_chunks(n_dev)
    sc = 0.0
    if step.mode == "pack8":
        if wire.participation is None:
            sc += wire.scalar_bytes() * chunks
    elif step.mode != "decoded":
        sc += wire.weight_bytes() * chunks
    if step.share_linf:
        sc += collectives.allreduce_scalar_bytes(wire.n_workers)
    return total - sc, sc


def tp_slice_ledger_split(step, model) -> tuple:
    """(payload, scalar) of a device's uplink ledger under tensor
    parallelism, split as the census splits it. Bucketed, the slice plan's
    ``plan_ledger`` (``step.plan``: each cut leaf's slice, each replicated
    leaf whole, in one plan a device), or the streamed step's two plans'
    ``streamed_plan_ledger`` (``step.plans``). Per leaf, each cut leaf's
    slice (its slice wire, ``VoteWire.for_slice``), each replicated leaf
    whole, the streamed step's block leaves once a layer at a layer's size;
    the ternary gather wires' elastic weight, pack8's decode scale (without
    a weight beside it) and the shared L-inf max are scalars, the side
    channels once a ring chunk."""
    if hasattr(step, "plans"):   # the streamed step
        block_plan, outer_plan = step.plans
        if block_plan is not None:
            return bucketing.streamed_plan_ledger(step.mode, step.wire, block_plan, outer_plan,
                                                  step.n_repeats, share_linf=step.share_linf)
        shapes = model.param_shapes()
        payload = scalar = 0.0
        for k in sorted(shapes):
            times, skip = (step.n_repeats, 1) if k == "blocks" else (1, 0)
            for sd, lay in zip(tree_leaves(shapes[k]), tree_leaves(step.layout[k])):
                p, sc = _slice_split(step, math.prod(sd.shape[skip:]),
                                     lay.parts if lay.tp else 1)
                payload += times * p
                scalar += times * sc
        return payload, scalar
    if step.plan is not None:
        return bucketing.plan_ledger(step.mode, step.wire, step.plan,
                                     share_linf=step.share_linf)
    payload = scalar = 0.0
    for n, pl in zip(_leaf_sizes(model), tree_leaves(step.placements)):
        p, sc = _slice_split(step, n, pl.parts if pl.sharded else 1)
        payload += p
        scalar += sc
    return payload, scalar


def tp_slice_ledger(step, model) -> float:
    """A device's uplink ledger under tensor parallelism: each cut leaf's
    slice, each replicated leaf whole (the step's wire_bytes_per_device)."""
    return sum(tp_slice_ledger_split(step, model))


def run_tp_census_checks(device: str = "cuda") -> tuple:
    """At (4, 2) on each ``TP_SETUPS`` wire: each model rank's device's
    recorded wire bytes == the slice ledger, payload and billed scalars, and
    a note of the 'model' axis's own reductions (role ``tp``: the ordered
    all-reduces of the row-parallel partials, the embedding, the loss and
    the whole-leaf statistics; the MoE FFN's expert partials; the mamba2
    mixer's gated-norm sums of squares, counted apart by their
    ``CollectiveRecord.what``), which the uplink ledger does not bill."""
    rule = CollectiveCensus()
    findings, checks = [], 0
    for setup in TP_SETUPS:
        census, model, step = run_tp_step(setup, device)
        payload, scalar = tp_slice_ledger_split(step, model)
        for rank in range(TP_T):
            findings += rule.check(f"step[tp {TP_M}x{TP_T} {setup} rank {rank}]",
                                   census.for_model_rank(rank), ledger_payload=payload,
                                   ledger_scalar=scalar)
            checks += 1
        tp = census.tp_records()
        named = {}
        for r in tp:
            if r.what:
                named[r.what] = named.get(r.what, 0) + 1
        among = "".join(f", {n} of them the {what}" for what, n in sorted(named.items()))
        findings.append(rule.finding(
            f"step[tp {TP_M}x{TP_T} {setup}]",
            f"{len(tp)} reductions over 'model' (role tp: {len(tp)} calls, "
            f"{sum(r.ring_bytes() for r in tp):.1f} B billed as all-reduces, "
            f"{sum(r.moved_bytes() for r in tp):.1f} B moved as rank-order gathers between "
            f"processes{among}), not in the uplink ledger", severity="info"))
    return findings, checks


def mode_count_budget(mode: str, model, *, bucketed: bool, m: int = HYPOTHETICAL_M) -> tuple:
    """(payload launches, scalar launch cap) of one simple-mode round, JAX's
    budget: a payload exchange a leaf (a ring: a chunk), or a bucket; plus
    the bucketed pack8 scale vector and the shared L-inf vector."""
    from repro_torch.core import engine
    sizes = _leaf_sizes(model)
    share = engine.needs_shared_linf(mode_comp(mode))
    wire = mode_wire(mode, m)
    if not bucketed:
        expected = sum(wire.ring_chunks(n) for n in sizes)
        return expected, len(sizes) + expected + 8
    plan = mode_bucket_plan(mode, model, m)
    if mode in RING_SETUPS:
        chunks = sum(wire.bucket_ring_chunks(b) for b in plan.buckets)
        extra = (chunks if wire_mode_of(mode) == "pack8" else 0) + (1 if share else 0)
        return chunks + extra, 8
    extra = (1 if mode == "pack8" else 0) + (1 if share else 0)
    return len(plan.buckets) + extra, 8


def count_check(mode: str, m: int = HYPOTHETICAL_M, device: str = "cuda", *,
                bucketed: bool) -> tuple:
    census, model, _ = run_mode_step(mode, m, device, bucketed=bucketed)
    expected, max_scalar = mode_count_budget(mode, model, bucketed=bucketed, m=m)
    return (CollectiveCountBudget().check(_label(mode, bucketed), census,
                                          expected_payload=expected, max_scalar=max_scalar),
            census, expected)


def count_ratio_checks(m: int = HYPOTHETICAL_M) -> tuple:
    """On every stacked-block config the bucketed wire launches >=
    MIN_COUNT_RATIO x fewer payload collectives than the per-leaf wire, for
    every mode: plan arithmetic over the shape trees."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    rule = CollectiveCountBudget()
    findings, checks = [], 0
    for name in RATIO_CONFIGS:
        model = Model(get_config(name))
        for mode in MODE_SETUPS:
            per_leaf, _ = mode_count_budget(mode, model, bucketed=False, m=m)
            bucketed, _ = mode_count_budget(mode, model, bucketed=True, m=m)
            checks += 1
            if per_leaf < MIN_COUNT_RATIO * bucketed:
                findings.append(rule.finding(
                    f"{name}[{mode}]",
                    f"bucketed wire launches {bucketed} payload collectives vs {per_leaf} "
                    f"per-leaf — ratio {per_leaf / max(bucketed, 1):.1f}x is under the "
                    f"{MIN_COUNT_RATIO:.0f}x floor"))
    return findings, checks


def run_count_checks(m: int = HYPOTHETICAL_M, device: str = "cuda") -> tuple:
    findings, checks = [], 0
    for mode in list(MODE_SETUPS) + list(RING_SETUPS):
        for bucketed in (False, True):
            findings += count_check(mode, m, device, bucketed=bucketed)[0]
            checks += 1
    f, c = count_ratio_checks(m)
    return findings + f, checks + c


def elastic_count_budget(mode: str, model, *, bucketed: bool, m: int = HYPOTHETICAL_M) -> tuple:
    """(payload launches, scalar cap) of the ELASTIC step, JAX's: the psum
    wires all-reduce two float32 arrays an exchange (weighted votes, W),
    pack8 gathers its (2,) side vector beside every payload, the ternary
    gather wires and decoded one payload."""
    from repro_torch.core import engine
    sizes = _leaf_sizes(model)
    share = engine.needs_shared_linf(mode_comp(mode))
    per = 2 if (wire_mode_of(mode) == "pack8"
                or (mode != "decoded" and _setup_of(mode)[2] == "psum")) else 1
    if not bucketed:
        return per * len(sizes), 3 * len(sizes) + 8
    plan = mode_bucket_plan(mode, model, m)
    return per * len(plan.buckets) + (1 if share else 0), len(plan.buckets) + 8


def run_participation_checks(m: int = HYPOTHETICAL_M, device: str = "cuda") -> tuple:
    """The elastic gate: every setup's ELASTIC step (per leaf and bucketed)
    run once with the recorder open, held to the elastic ledger, the elastic
    launch budget and MaskedPayloadZero (the round's dropped workers ship
    zeros); the ring setups' bucketed elastic steps to MaskedPayloadZero."""
    findings, checks, rows = [], 0, []
    census_rule, count_rule, mask_rule = (CollectiveCensus(), CollectiveCountBudget(),
                                          MaskedPayloadZero())
    dropped = dropped_workers(m)
    for mode in MODE_SETUPS:
        for bucketed in (False, True):
            census, model, _ = run_mode_step(mode, m, device, bucketed=bucketed, elastic=True)
            label = _label(mode, bucketed, True)
            if bucketed:
                payload, scalar, _ = mode_bucketed_ledger(mode, model, m, elastic=True)
            else:
                payload, scalar = elastic_mode_ledger(mode, model, m)
            findings += census_rule.check(label, census, ledger_payload=payload,
                                          ledger_scalar=scalar)
            rows.append((label, census))
            expected, max_scalar = elastic_count_budget(mode, model, bucketed=bucketed, m=m)
            findings += count_rule.check(label, census, expected_payload=expected,
                                         max_scalar=max_scalar)
            findings += mask_rule.check(label, census, dropped)
            checks += 3
    for mode in RING_SETUPS:
        census, _, _ = run_mode_step(mode, m, device, bucketed=True, elastic=True)
        findings += mask_rule.check(_label(mode, True, True), census, dropped)
        checks += 1
    return findings + moved_note(census_rule, "participation", rows), checks


# ---------------------------------------------------------------------------
# Ledger floors: the entropy-coded wire and the ring's residency
# ---------------------------------------------------------------------------

def entropy_wire_ledgers(model, m: int = HYPOTHETICAL_M) -> tuple:
    """((golomb, pack2) per leaf, (golomb, pack2) bucketed) payload bytes of
    one round of ``model``: the formulas the census pins bytes against."""
    gw = mode_wire("golomb", m)
    pw = collectives.PackedVoteWire(group=_group(m), n_workers=m)
    leaves = tree_leaves(model.param_shapes())
    sizes = _leaf_sizes(model)
    g_leaf = sum(gw.wire_bytes(n) for n in sizes)
    p_leaf = sum(pw.wire_bytes(n) for n in sizes)
    g_plan = bucketing.build_bucket_plan(leaves, "golomb", rows_fn=gw.payload_rows)
    p_plan = bucketing.build_bucket_plan(leaves, "pack2")
    g_bucket, _ = bucketing.plan_ledger("votes", gw, g_plan)
    p_bucket, _ = bucketing.plan_ledger("votes", pw, p_plan)
    return (g_leaf, p_leaf), (g_bucket, p_bucket)


def entropy_wire_checks(m: int = HYPOTHETICAL_M) -> tuple:
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    rule = EntropyWireBudget(MIN_ENTROPY_RATIO)
    findings, checks = [], 0
    for name in RATIO_CONFIGS:
        (g_leaf, p_leaf), (g_bucket, p_bucket) = entropy_wire_ledgers(Model(get_config(name)), m)
        findings += rule.check(f"{name}[per-leaf]", golomb_bytes=g_leaf, pack2_bytes=p_leaf)
        findings += rule.check(f"{name}[bucketed]", golomb_bytes=g_bucket, pack2_bytes=p_bucket)
        checks += 2
    return findings, checks


def _ring_wire_pair(mode: str, m: int, chunk_rows: int) -> tuple:
    cls, kw = {"ring_pack8": (collectives.Pack8Wire, {}),
               "ring_golomb": (collectives.GolombWire, {"p": GOLOMB_P})}.get(
        mode, (collectives.PackedVoteWire, {}))
    base = dict(group=_group(m), n_workers=m, **kw)
    return cls(**base), cls(ring_chunk_rows=chunk_rows, **base)


def gather_hbm_checks(m: int = HYPOTHETICAL_M) -> tuple:
    """The ring's peak gathered payload undercuts the monolithic gather's by
    >= M/2 on every stacked-block config, per leaf and bucketed, at the
    default chunk size."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    rule = GatherHbmBudget(min_ratio=m / 2.0)
    findings, checks = [], 0
    for name in RATIO_CONFIGS:
        model = Model(get_config(name))
        leaves = tree_leaves(model.param_shapes())
        sizes = _leaf_sizes(model)
        for mode in RING_SETUPS:
            mono, ring = _ring_wire_pair(mode, m, collectives.DEFAULT_RING_CHUNK_ROWS)
            findings += rule.check(f"{name}[{mode}/per-leaf]",
                                   ring_bytes=max(ring.gather_hbm_bytes(n) for n in sizes),
                                   mono_bytes=max(mono.gather_hbm_bytes(n) for n in sizes))
            emode = wire_mode_of(mode)
            fmt = bucketing.wire_bucket_format(emode, mono)
            plan = bucketing.build_bucket_plan(
                leaves, fmt, rows_fn=(mono.payload_rows if fmt == "golomb" else None))
            findings += rule.check(f"{name}[{mode}/bucketed]",
                                   ring_bytes=bucketing.plan_gather_hbm_bytes(emode, ring, plan),
                                   mono_bytes=bucketing.plan_gather_hbm_bytes(emode, mono, plan))
            checks += 2
    return findings, checks


# ---------------------------------------------------------------------------
# The registry's fused wire ops
# ---------------------------------------------------------------------------

#: a fused op's gradient: 2^16 coordinates against the plain chain, 2^24 for
#: the one-launch check (a gradient-sized intermediate would be 16 MB or more)
SPEC_N = 1 << 16
LAUNCH_N = 1 << 24

#: each packed wire format's fused encoder, by the name its kernel carries
ENCODER_KERNEL = {"pack2": "encode_kernel<", "pack8": "encode_kernel<",
                  "golomb": "encode_tiles<"}

#: the port's kernel functions (``csrc/``), as the profiler names them
PORT_KERNELS = ("ef_server_kernel", "class_pass", "count_pass", "emit_tiles", "encode_kernel",
                "encode_tiles", "mark_pass", "pack2bit_kernel", "scan_blocks", "scan_totals",
                "sparsign_kernel", "ternary_kernel", "unpack2bit_kernel",
                "unpack2bit_sum_kernel", "unpack2bit_wsum_kernel", "unpack8_sum_kernel",
                "vote_update_kernel", "weighted_vote_update_kernel")


def _fused_kwargs(spec) -> dict:
    return {"p": GOLOMB_P} if spec.wire_format == "golomb" else {}


def _spec_param(spec, g: torch.Tensor):
    """The op's param, resolved outside it (JAX's run_spec_checks): the
    spec's local scale, else a budget of 1."""
    return spec.local_scale(g, False) if spec.local_scale is not None else 1.0


def plain_chain(spec, g: torch.Tensor, param, seed: int) -> torch.Tensor:
    """The fused op's bytes the two-pass way: the spec's plain values, then
    the plain pack of its wire format."""
    from repro_torch.kernels.common import to_2d
    from repro_torch.kernels.golomb.ref import golomb_encode_ref
    from repro_torch.kernels.pack2bit.ref import pack2bit_ref
    values = spec.values(g, param, seed, 0)
    if spec.wire_format == "golomb":
        return golomb_encode_ref(values, p=GOLOMB_P)
    view = to_2d(values.reshape(-1))[0]
    return view if spec.wire_format == "pack8" else pack2bit_ref(view)


#: torch.profiler sessions one trace may take: on the card a session now
#: and then sees no device activity at all (benchmarks/torch_profiler_probe.py;
#: most sessions after a trace of some 400,000 kernels in one process), so a
#: blind one is taken again
TRACE_TRIES = 3


def _traced_kernels(fn) -> tuple:
    """(the port's kernels one call of ``fn`` launched, by the profiler's
    names in order, and the count of all device activities it saw). A
    session that sees no device activity is retaken, up to TRACE_TRIES."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pat = re.compile(r"\b(" + "|".join(PORT_KERNELS) + r")\b[<(]")
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if events:
            break
    return [e.name for e in events if pat.search(e.name)], len(events)


def fused_launch_check(spec, device: str = "cuda") -> list:
    """FusedOneLaunch on the card for one spec: the port's launches of one
    ``engine.compress_leaf`` on the wire of its format, by its wrappers'
    counts and by the profiler, and the memory the fused op allocates
    beyond its output (its param resolved outside)."""
    from repro_torch import kernels
    from repro_torch.core import engine
    from repro_torch.core.algorithm import CompressionConfig
    from repro_torch.core.budgets import BudgetConfig
    gen = torch.Generator(device=device).manual_seed(11)
    g = torch.randn(LAUNCH_N, generator=gen, device=device).to(torch.bfloat16)
    cfg = CompressionConfig(compressor=spec.name, budget=BudgetConfig(value=1.0),
                            server="majority_vote" if spec.is_ternary else "mean")
    wire = (mode_wire("golomb", 4) if spec.wire_format == "golomb" else
            mode_wire("pack8", 4) if spec.wire_format == "pack8" else
            mode_wire("ring_pack2", 4))
    engine.compress_leaf(g, cfg, 7, wire=wire)   # warm: the library loads once
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    engine.compress_leaf(g, cfg, 7, wire=wire)
    moved = {k: v - before[k] for k, v in kernels.launch_counts().items() if v != before[k]}
    port, seen = _traced_kernels(lambda: engine.compress_leaf(g, cfg, 7, wire=wire))
    param = _spec_param(spec, g)
    seed = torch.full((), 7, dtype=torch.int64, device=device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = spec.fused_pack_op(g, param, seed, 0, **_fused_kwargs(spec))
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - out.numel() * out.element_size()
    return FusedOneLaunch().check(f"{spec.name}.fused_pack_op", wrapper_launches=moved,
                                  port_kernels=port, device_kernels=seen,
                                  encoder=ENCODER_KERNEL[spec.wire_format], extra_bytes=extra)


def run_spec_checks(device: str = "cuda") -> tuple:
    """Every fused wire op of the registry against its plain chain, byte for
    byte, in float32 and bfloat16 (on the CPU the op is the plain fused
    version, on the card the kernel); on the card also FusedOneLaunch."""
    from repro_torch.core.compressors import SPECS

    rule = FusedEqualsPlain()
    findings, checks = [], 0
    gen = torch.Generator(device=device).manual_seed(11)
    g32 = torch.randn(SPEC_N, generator=gen, device=device)
    for spec in SPECS.values():
        if spec.fused_pack_op is None:
            continue
        for g in (g32, g32.to(torch.bfloat16)):
            param = _spec_param(spec, g)
            findings += rule.check(f"{spec.name}.fused_pack_op[{str(g.dtype).split('.')[-1]}]",
                                   spec.fused_pack_op(g, param, 7, 0, **_fused_kwargs(spec)),
                                   plain_chain(spec, g, param, 7))
            checks += 1
        if device != "cpu":
            findings += fused_launch_check(spec, device)
            checks += 1
    return findings, checks
