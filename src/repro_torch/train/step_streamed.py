"""`streamed`-mode train step, the port of ``repro.train.step_streamed``: for
models whose gradient does not fit beside their weights (qwen2-vl-72b,
jamba-1.5-large-398b, llama4-scout-17b-a16e).

Every parameter leaf is FSDP-sharded over the M workers of a
``WorkerGroup`` along one axis (``build_fsdp_layout``: the largest axis M
divides, skipping a block leaf's repeat axis and the axes tensor parallelism
would claim; ``REPLICATED`` when none fits). A process holds the shards of
its ``local`` workers, contiguous, ranks in order (``streamed_layout``); in
one process that is every leaf whole. One round, in one process:

  forward   every worker's microbatch, block by block (a superblock is one
            repeat of the pattern), without a graph; each layer's slices are
            gathered once (``collectives.fsdp_all_gather``, the leaf itself
            in one process) and each superblock's input ``h`` kept;
  head      each worker's loss and the gradients of the head's leaves
            (``final_norm``, ``lm_head``) and of the last ``h``;
  backward  in reverse layer order, for each worker: recompute the
            superblock from its stored input, ``torch.autograd.grad`` for the
            layer's leaves and ``h``, compress each leaf into the worker's
            wire message and free the gradient before the next worker; then
            one exchange a leaf (or a bucket) and the server's C(.) and SGD
            on this process's slice, written into layer l of the stacked
            leaf in place;
  outer     the embedding's gradient from each worker's gradient of the
            first ``h`` (the head does not read the untied embedding, so
            JAX's ``g_outer["embed"] + g_embed`` is ``g_embed``), then the
            outer leaves' exchange and server.

The peak is about the weights, one worker's block gradient, M messages of a
layer and the stored inputs; no two workers' graphs live at once. A
compressor that shares the workers' L-inf norm (TernGrad, ``linf_share``)
holds every worker's gradients of a layer (or of the outer leaves) until the
shared max is known.

Seeds and counters are the simple step's: worker w's stream seed, leaf i
(its position in the whole tree's flatten order) drawing from
``fold(wseed, i)``, a block leaf of layer l at counter base ``l * n`` (n the
layer's coordinates), which is the offset of layer l in the stacked leaf. A
block leaf is exchanged once a layer, so its messages are padded a layer,
as JAX's ledger bills them; a compressor whose budget or scale reads the
whole leaf (an L2 or L-inf norm, a target sparsity) reads the layer's.

``bucketed=True`` is JAX's double-buffered backward: one bucket plan for a
layer's leaves and one for the outer leaves; iteration l first exchanges and
applies the pending buckets of layer l + 1, then recomputes and compresses
layer l into fresh buckets. The pipe is primed with zero buckets, whose
exchange really runs and is dropped, and the last pending buckets drain
after the loop, so each block bucket rides the wire ``n_repeats + 1`` times,
as ``bucketing.streamed_plan_ledger`` bills it. The exchange is not
overlapped with the recompute (ROADMAP.md).

The scaled-sign EF server's L1 norm sums each worker's shard's partial, in
worker order (``collectives.ordered_sum`` of the gathered partials), where
JAX sums them over the FSDP axis; a replicated leaf's server math runs once
a process. Like the simple step's, the step writes each new slice into the
input state's tensors; the input state must not be read again.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import engine, prng
from repro_torch.core.algorithm import CompressionConfig, worker_stream_seed
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.dist import bucketing, collectives
from repro_torch.dist.collectives import ParticipationSpec, WorkerGroup
from repro_torch.dist.sharding import TP_RULES
from repro_torch.models.common import rms_norm
from repro_torch.train import sampling
from repro_torch.train.state import LrSchedule, TrainState
from repro_torch.train.step_simple import worker_batch

REPLICATED = -1   # the shard axis of a leaf no axis of which M divides


@dataclasses.dataclass(frozen=True)
class StreamedStepConfig:
    compression: CompressionConfig
    lr: LrSchedule
    vote_impl: str = "psum"        # psum | hier | allgather_packed
    quorum: Any = 1                # int, or a tree prefix of the params with per-leaf ints
    backend: Optional[str] = None  # None: the kernels for CUDA tensors, plain for CPU
    bucketed: bool = False         # bucketed uplink, double-buffered over the layers
    bucket_bytes: Optional[int] = None      # payload cap a bucket (None: one a group)
    golomb_p: Optional[float] = None        # the golomb wire's plan-time nnz fraction
    ring_chunk_rows: Optional[int] = None   # ring gather: payload rows a chunk
    participation: Optional[ParticipationSpec] = None


# ---------------------------------------------------------------------------
# The FSDP layout
# ---------------------------------------------------------------------------

def fsdp_shard_axis(shape, n_shards: int, min_axis: int = 0, avoid=()) -> int:
    """The largest axis (>= min_axis, not in ``avoid``) that ``n_shards``
    divides; REPLICATED if none. ``avoid`` holds the axes tensor parallelism
    claims."""
    best, best_size = REPLICATED, 0
    for ax in range(min_axis, len(shape)):
        if ax in avoid:
            continue
        if shape[ax] % n_shards == 0 and shape[ax] >= n_shards and shape[ax] > best_size:
            best, best_size = ax, shape[ax]
    return best


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def _logical_leaves(tree) -> list:
    """The logical-axes tuples of a tree, in ``tree_leaves``' order."""
    if _is_logical(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _logical_leaves(tree[k])]
    return [x for item in tree for x in _logical_leaves(item)]


def build_fsdp_layout(shapes_tree, n_shards: int, min_axis: int = 1, logical_tree=None):
    """The shard-axis tree of ``shapes_tree`` (JAX's ``build_fsdp_layout``'s
    second output): ``min_axis=1`` skips a block leaf's repeat axis; with
    ``logical_tree`` the axes that ``TP_RULES`` places are avoided."""
    leaves = tree_leaves(shapes_tree)
    logical = (_logical_leaves(logical_tree) if logical_tree is not None
               else [()] * len(leaves))
    axes = []
    for s, lg in zip(leaves, logical):
        avoid = tuple(i for i, name in enumerate(lg)
                      if name is not None and TP_RULES.get(name) is not None)
        axes.append(fsdp_shard_axis(tuple(s.shape), n_shards, min_axis, avoid))
    return tree_unflatten(shapes_tree, axes)


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """Where one leaf lives: its whole ``shape``, its shard ``axis`` (or
    REPLICATED) and this process's slice along it, ``size`` indices from
    ``start``: the ``shard``-sized shards of its local workers."""
    shape: Tuple[int, ...]
    axis: int
    start: int
    size: int
    shard: int

    @property
    def whole(self) -> bool:
        """Whether this process holds the whole leaf."""
        return self.axis == REPLICATED or self.size == self.shape[self.axis]

    def cut(self, x: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
        """This process's slice of a whole leaf ``x`` (a view; ``x`` itself
        when the process holds all of it). ``axis`` overrides the shard axis,
        for one layer of a stacked leaf."""
        if self.whole:
            return x
        return x.narrow(self.axis if axis is None else axis, self.start, self.size)


def streamed_layout(model, group: WorkerGroup) -> dict:
    """The parameter tree of ``LeafLayout``s over the group's M workers: the
    port's counterpart of JAX's ``streamed_shardings``."""
    shapes, logical = model.param_shapes(), model.param_logical_axes()
    n, rank, local = group.n_workers, group.rank, group.local
    out = {}
    for k in shapes:
        axes = tree_leaves(build_fsdp_layout(shapes[k], n, min_axis=1 if k == "blocks" else 0,
                                             logical_tree=logical[k]))
        lays = []
        for sd, ax in zip(tree_leaves(shapes[k]), axes):
            shape = tuple(sd.shape)
            if ax == REPLICATED:
                lays.append(LeafLayout(shape, REPLICATED, 0, 0, 0))
                continue
            shard = shape[ax] // n
            lays.append(LeafLayout(shape, ax, rank * local * shard, local * shard, shard))
        out[k] = tree_unflatten(shapes[k], lays)
    return out


def shard_tree(tree, layout):
    """A tree of whole leaves cut to this process's slices (copies, so the
    whole leaves can be freed); a leaf the process holds whole is kept as
    it is."""
    return tree_unflatten(tree, [x if lay.whole else lay.cut(x).clone()
                                 for x, lay in zip(tree_leaves(tree), tree_leaves(layout))])


def shard_state(state: TrainState, layout) -> TrainState:
    """A state of whole leaves cut to this process's slices: the port's
    ``fsdp_param_shardings`` placement."""
    return TrainState(params=shard_tree(state.params, layout),
                      ef_residual=(shard_tree(state.ef_residual, layout)
                                   if state.ef_residual is not None else None),
                      step=state.step, seed=state.seed)


def state_shardings(layout, state: TrainState) -> TrainState:
    """The ``checkpoint.restore(shardings=)`` tree of a streamed state: the
    layout for the parameters and the EF residual, None (whole) elsewhere."""
    return TrainState(params=layout,
                      ef_residual=layout if state.ef_residual is not None else None,
                      step=None, seed=None)


def gather_tree(tree, layout, group: WorkerGroup):
    """This process's slices -> whole leaves (the leaves themselves in one
    process)."""
    return tree_unflatten(tree, [x if lay.whole else
                                 collectives.fsdp_all_gather(x, group, lay.axis)
                                 for x, lay in zip(tree_leaves(tree), tree_leaves(layout))])


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

class _Messages:
    """One exchange group's messages for this process's workers: a layer's
    block leaves, or the outer leaves. Per leaf, each worker's message and
    decode scale (decoded mode: its values and scale); bucketed, a
    (local, rows, width) buffer a bucket that each message is written into."""

    def __init__(self, plan, n_leaves: int, local: int, device, zero_scales: bool = False):
        self.plan = plan
        self.msgs = [[] for _ in range(n_leaves)]
        self.scales = [[] for _ in range(n_leaves)]
        self.bufs = None
        if plan is not None:
            self.slot_of = {s.index: (bi, s) for bi, b in enumerate(plan.buckets)
                            for s in b.slots}
            self.bufs = [torch.zeros((local, b.rows, bucketing.ROW_WIDTH[plan.fmt]),
                                     dtype=bucketing.ROW_DTYPE[plan.fmt], device=device)
                         for b in plan.buckets]
            if zero_scales:   # the priming buckets: every decode scale 1.0
                one = torch.ones((), dtype=torch.float32, device=device)
                self.scales = [[one] * local for _ in range(n_leaves)]


def build_streamed_train_step(model, step_cfg: StreamedStepConfig,
                              group: WorkerGroup) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), ``state``
    holding this process's slices (``shard_state``). Build-time refusals
    (``ValueError``): tail blocks, tied embeddings, tau > 1. A 'model' axis
    of size T > 1 is not ported yet (``NotImplementedError``)."""
    if group.model_size > 1:
        raise NotImplementedError("the streamed trainer with a tensor-parallel 'model' axis "
                                  f"of {group.model_size} is not ported yet")
    cfg = model.cfg
    comp = step_cfg.compression
    if cfg.tail_pattern:
        raise ValueError(f"{cfg.name}: the streamed trainer runs whole pattern repeats and "
                         f"does not support tail blocks; use the simple trainer")
    if cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: the streamed trainer expects untied embeddings; use "
                         f"the simple trainer")
    if comp.local_steps != 1:
        raise ValueError(f"the streamed trainer runs Algorithm 1's exchange (tau = 1), got "
                         f"tau = {comp.local_steps}; use the simple trainer for Algorithm 2")
    mode = engine.wire_mode(comp, vote_impl=step_cfg.vote_impl)
    wire_fmt = engine.wire_payload_format(comp, mode, vote_impl=step_cfg.vote_impl)
    part = step_cfg.participation
    if part is not None:
        engine.check_participation_server(comp.server, comp.compressor)
    wire = collectives.make_vote_wire(
        step_cfg.vote_impl, group, backend=step_cfg.backend, wire_format=wire_fmt,
        golomb_p=(engine.resolve_golomb_p(comp, step_cfg.golomb_p)
                  if wire_fmt == "golomb" else None),
        ring_chunk_rows=engine.resolve_ring_chunk_rows(step_cfg.ring_chunk_rows,
                                                       step_cfg.vote_impl),
        participation=part)
    count_dropped = wire.native_format == "golomb"
    share_linf = engine.needs_shared_linf(comp)
    if mode != "votes" and engine.needs_server_ef(comp.server):
        raise ValueError(
            f"server {comp.server!r} keeps an error-feedback residual that only updates on "
            f"the integer vote wire, but compressor {comp.compressor!r} rides the {mode!r} "
            f"wire; use a ternary vote-wire compressor or a plain 'mean' server")
    shapes = model.param_shapes()
    quorum_flat = tree_leaves(engine.broadcast_quorum(step_cfg.quorum, shapes))
    q_frac_flat = ([part.resolve_q_frac(q, wire.n_workers) for q in quorum_flat]
                   if part is not None else None)
    if mode != "votes" and any(q != 1 for q in quorum_flat):
        raise ValueError(
            f"quorum={step_cfg.quorum!r} is a vote-server deadband, but compressor "
            f"{comp.compressor!r} with server {comp.server!r} rides the {mode!r} wire where "
            f"it would be ignored; use a vote server ({engine.VOTE_SERVERS}) or quorum=1")
    layout = streamed_layout(model, group)
    outer_keys = sorted(k for k in shapes if k != "blocks")
    head_keys = [k for k in outer_keys if k != "embed"]
    # each leaf's position in the whole tree's flatten order (its seed salt)
    flat_idx, at = {}, 0
    for k in sorted(shapes):
        flat_idx[k] = list(range(at, at + len(tree_leaves(shapes[k]))))
        at += len(flat_idx[k])
    blocks_idx = flat_idx["blocks"]
    outer_idx = [flat_idx[k][0] for k in outer_keys]
    block_shapes = [tuple(sd.shape[1:]) for sd in tree_leaves(shapes["blocks"])]
    outer_shapes = [tuple(shapes[k].shape) for k in outer_keys]
    block_lays = tree_leaves(layout["blocks"])
    outer_lays = [layout[k] for k in outer_keys]
    n_rep, n_blk = cfg.n_repeats, len(block_shapes)
    total = sum(math.prod(sd.shape) for sd in tree_leaves(shapes))

    # the per-device uplink ledger: a block leaf exchanges once a layer at its
    # layer's size, an outer leaf once at its size (JAX's sums, in its order)
    def exchange_bytes(n: int) -> float:
        return collectives.uplink_ledger(mode, wire, n, share_linf=share_linf)

    wire_ledger = sum(n_rep * exchange_bytes(math.prod(s)) for s in block_shapes)
    wire_ledger += sum(exchange_bytes(math.prod(s)) for s in outer_shapes)
    gather_hbm = 0.0
    if mode != "decoded":
        gather_hbm = max([wire.gather_hbm_bytes(math.prod(s))
                          for s in block_shapes + outer_shapes], default=0.0)
    block_plan = outer_plan = None
    if step_cfg.bucketed:
        fmt = bucketing.wire_bucket_format(mode, wire)
        rows_fn = wire.payload_rows if fmt == "golomb" else None
        block_plan = bucketing.build_bucket_plan(block_shapes, fmt,
                                                 bucket_bytes=step_cfg.bucket_bytes,
                                                 rows_fn=rows_fn)
        outer_plan = bucketing.build_bucket_plan(outer_shapes, fmt,
                                                 bucket_bytes=step_cfg.bucket_bytes,
                                                 rows_fn=rows_fn)
        pay, scal = bucketing.streamed_plan_ledger(mode, wire, block_plan, outer_plan, n_rep,
                                                   share_linf=share_linf)
        wire_ledger = pay + scal
        gather_hbm = max(bucketing.plan_gather_hbm_bytes(mode, wire, block_plan),
                         bucketing.plan_gather_hbm_bytes(mode, wire, outer_plan))
    ring = mode != "decoded" and getattr(wire, "ring_chunk_rows", None) is not None
    n_workers, local = group.n_workers, group.local
    backend = step_cfg.backend

    def l1_reduce_of(lay: LeafLayout, axis: int):
        """The scaled-sign L1 of a sharded leaf: each local worker's shard's
        partial, gathered over the processes and added in worker order."""
        if lay.axis == REPLICATED:
            return None

        def reduce(mag: torch.Tensor) -> torch.Tensor:
            parts = torch.stack([torch.sum(c) for c in mag.split(lay.shard, dim=axis)])
            return collectives.ordered_psum(parts, group, role="scalar")

        return reduce

    def step(state: TrainState, batch: dict):
        params = state.params
        has_ef = state.ef_residual is not None
        blk = tree_leaves(params["blocks"])
        blk_ef = tree_leaves(state.ef_residual["blocks"]) if has_ef else [None] * n_blk
        dev = blk[0].device
        widx = collectives.worker_index(group, dev)
        rseed = sampling.round_seed(state.seed, state.step)
        mask = sampling.participation_mask(rseed, state.step, widx,
                                           comp.worker_sample_fraction)
        w_eff = None
        if part is not None:
            mask = mask & sampling.report_mask(rseed, state.step, widx, part.dropout)
            w_eff = part.weights_array(n_workers, dev)[widx] * mask.to(torch.float32)
        lr = step_cfg.lr(state.step)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        n_sel = collectives.scalar_psum(mask.to(torch.float32), group)
        n_dec = (collectives.scalar_psum(w_eff, group) if part is not None else n_sel)
        nnz, dropped = [zero] * local, [zero] * local
        workers = range(group.rank * local, group.rank * local + local)
        seeds = [worker_stream_seed(rseed, w) for w in workers]
        micro = [worker_batch(batch, w, n_workers, 0, dev) for w in workers]

        def full_layer(l: int) -> list:
            return [x[l] if lay.whole else collectives.fsdp_all_gather(x[l], group, lay.axis - 1)
                    for x, lay in zip(blk, block_lays)]

        def as_blocks(leaves):
            return tree_unflatten(shapes["blocks"], leaves)

        def compress(msgs: _Messages, j: int, i: int, g, seed_i, base, shared):
            """Worker j's message of leaf i of a group, into ``msgs``."""
            slot = msgs.slot_of[i] if msgs.plan is not None else None
            if mode == "decoded":
                msg = engine.compress_leaf(g, comp, seed_i, base, backend=backend,
                                           shared_linf=shared)
                sc = msg.scale * w_eff[j] if part is not None else msg.scale
                if slot is None:
                    msgs.msgs[i].append(msg.values)
                    msgs.scales[i].append(sc)
                    return
                values, k = collectives.decoded_message(msg.values, sc, mask[j],
                                                        is_ternary=comp.is_ternary)
                nnz[j] = nnz[j] + k
                values = bucketing.as_rows(values, msgs.plan.fmt, slot[1].rows)
            else:
                if slot is None:
                    msg = engine.compress_leaf(g, comp, seed_i, base, backend=backend,
                                               wire=wire, shared_linf=shared)
                else:
                    msg = engine.compress_leaf_rows(g, comp, seed_i, base, rows=slot[1].rows,
                                                    backend=backend, wire=wire,
                                                    shared_linf=shared)
                values = wire.mask_message(msg.values, mask[j])
                msgs.scales[i].append(msg.scale)
                nnz[j] = nnz[j] + wire.message_nnz(values)
                if count_dropped:
                    dropped[j] = dropped[j] + wire.message_dropped(values)
                if slot is None:
                    msgs.msgs[i].append(values)
                    return
            bi, s = slot
            msgs.bufs[bi][j, s.row_start:s.row_start + s.rows] = values

        def compress_all(msgs, grads, salts, bases):
            """Every local worker's messages of a group: ``grads[j]`` holds
            worker j's leaves (all workers' at once for a shared L-inf)."""
            shared = None
            if share_linf:
                if msgs.plan is not None:
                    vec = collectives.worker_shared_linf_many(grads, group, mask=mask)
                    shared = [vec[i] for i in range(len(salts))]
                else:
                    shared = [collectives.worker_shared_linf([g[i] for g in grads], group,
                                                             mask=mask)
                              for i in range(len(salts))]
            for j, src in enumerate(grads):
                for i, g in enumerate(src):
                    compress(msgs, j, i, g, prng.fold_seed_int(seeds[j], salts[i]), bases[i],
                             shared[i] if shared is not None else None)

        def apply(i, agg, n_or_w, targets, msgs):
            """C(.) and SGD on this process's slice of leaf i of a group,
            written in place."""
            p, ef, lay, axis, size, li = targets[i]
            vs = lay.cut(agg, axis)
            wt = n_or_w if n_or_w.dim() == 0 else lay.cut(n_or_w, axis)
            if mode != "votes":
                mean_scale = msgs.scales[i][-1] if mode == "scaled_votes" else None
                new_p, new_ef = engine.server_apply(p, vs, comp, lr=lr, ef=ef, n_sel=wt,
                                                    server="mean", scale=mean_scale,
                                                    backend=backend)
            elif part is not None:
                new_p, new_ef = engine.server_apply(p, vs, comp, lr=lr, ef=ef, part_total=wt,
                                                    q_frac=q_frac_flat[li], backend=backend)
            else:
                new_p, new_ef = engine.server_apply(
                    p, vs, comp, lr=lr, ef=ef, n_sel=n_sel, leaf_size=size,
                    l1_reduce=l1_reduce_of(lay, axis), quorum=quorum_flat[li],
                    backend=backend)
            p.copy_(new_p)
            if ef is not None and new_ef is not ef:
                ef.copy_(new_ef)

        def exchange(msgs: _Messages, shapes_, targets):
            """One exchange a leaf or a bucket, then the servers; ``targets``
            None drops the sums (the priming buckets)."""
            nonlocal nnz
            if msgs.plan is None:
                for i, shape in enumerate(shapes_):
                    n = math.prod(shape)
                    stack = msgs.msgs[i] if ring else torch.stack(msgs.msgs[i])
                    msgs.msgs[i] = None
                    if mode == "decoded":
                        agg, k = collectives.decoded_exchange(
                            stack, torch.stack(msgs.scales[i]), mask, group,
                            is_ternary=comp.is_ternary)
                        nnz = [a + b for a, b in zip(nnz, k)]
                        n_or_w = n_dec
                    else:
                        wire_scale = torch.stack(msgs.scales[i]) if mode == "pack8" else None
                        if part is not None:
                            agg, n_or_w = wire.exchange_weighted(stack, n, shape, weight=w_eff,
                                                                 scale=wire_scale)
                        else:
                            agg, n_or_w = wire.exchange(stack, n, shape, scale=wire_scale), n_sel
                    del stack
                    apply(i, agg, n_or_w, targets, msgs)
                    del agg
                return
            for bi, b in enumerate(msgs.plan.buckets):
                buf, msgs.bufs[bi] = msgs.bufs[bi], None
                bscale = None
                if mode == "pack8":
                    bscale = torch.stack([torch.stack([msgs.scales[s.index][j] for s in b.slots])
                                          for j in range(local)])
                if mode == "decoded":
                    parts = bucketing.split_bucket(
                        collectives.decoded_exchange_bucket(buf, group), b)
                    wtots = n_dec
                elif part is not None:
                    parts, wtots = wire.exchange_bucket_weighted(buf, b, weight=w_eff,
                                                                 scale=bscale)
                else:
                    parts, wtots = wire.exchange_bucket(buf, b, scale=bscale), n_sel
                del buf
                if targets is not None:
                    for k, (s, agg) in enumerate(zip(b.slots, parts)):
                        apply(s.index, agg, wtots[k] if isinstance(wtots, list) else wtots,
                              targets, msgs)
                del parts

        def layer_targets(l: int) -> list:
            return [(x[l], ef[l] if ef is not None else None, lay,
                     lay.axis - 1 if lay.axis != REPLICATED else REPLICATED,
                     math.prod(shape), li)
                    for x, ef, lay, shape, li in zip(blk, blk_ef, block_lays, block_shapes,
                                                     blocks_idx)]

        # -- forward: every worker block by block, each block's input kept --
        outer_full = {k: params[k] if lay.whole else
                      collectives.fsdp_all_gather(params[k], group, lay.axis)
                      for k, lay in zip(outer_keys, outer_lays)}
        hs, inputs = [], [[None] * n_rep for _ in range(local)]
        pos = [(mb["positions"], mb.get("positions3")) for mb in micro]
        with torch.no_grad():
            for j in range(local):
                hs.append(model.embed_stage(outer_full, micro[j]))
            for l in range(n_rep):
                full = as_blocks(full_layer(l))
                for j in range(local):
                    inputs[j][l] = hs[j]
                    hs[j] = model.superblock_apply(full, hs[j], *pos[j])
                del full

        # -- head: loss and the head leaves' and h's gradients; each
        # worker's head messages at once (held under a shared L-inf) --------
        outer = _Messages(outer_plan, len(outer_keys), local, dev)
        held_outer = [dict() for _ in range(local)]
        losses, g_h = [], []

        def outer_message(j: int, k: str, g):
            if share_linf:
                held_outer[j][k] = g
            else:
                i = outer_keys.index(k)
                compress(outer, j, i, g, prng.fold_seed_int(seeds[j], outer_idx[i]), 0, None)

        for j in range(local):
            hp = {k: outer_full[k].detach().requires_grad_(True) for k in head_keys}
            hf = hs[j].detach().requires_grad_(True)
            hs[j] = None
            with torch.enable_grad():
                loss = model.head_loss(hp, rms_norm(hf, hp["final_norm"], cfg.norm_eps),
                                       micro[j]["labels"])
                grads = torch.autograd.grad(loss, [hp[k] for k in head_keys] + [hf])
            losses.append(loss.detach())
            g_h.append(grads[-1])
            for k, g in zip(head_keys, grads[:-1]):
                outer_message(j, k, g)
            del grads, hp, hf, loss, g
        hs = None

        # -- backward: per layer, per worker; then exchange and server ------
        pending = None
        if block_plan is not None:   # the zero buckets priming the pipe
            pending = (None, _Messages(block_plan, n_blk, local, dev, zero_scales=True))
        for l in reversed(range(n_rep)):
            if pending is not None:
                lp, msgs = pending
                exchange(msgs, block_shapes, layer_targets(lp) if lp is not None else None)
                pending = None
            full = full_layer(l)
            msgs = _Messages(block_plan, n_blk, local, dev)
            bases = [(l * math.prod(s)) & prng.MASK32 for s in block_shapes]
            held = []
            for j in range(local):
                ps = [x.detach().requires_grad_(True) for x in full]
                h_in = inputs[j][l].detach().requires_grad_(True)
                inputs[j][l] = None
                with torch.enable_grad():
                    out = model.superblock_apply(as_blocks(ps), h_in, *pos[j])
                    grads = torch.autograd.grad(out, ps + [h_in], g_h[j], allow_unused=True)
                g_h[j] = grads[-1]
                g = [gi if gi is not None else torch.zeros_like(p) for gi, p in zip(grads, ps)]
                del grads, out, ps, h_in
                if share_linf:
                    held.append(g)
                else:
                    for i, gi in enumerate(g):
                        compress(msgs, j, i, gi, prng.fold_seed_int(seeds[j], blocks_idx[i]),
                                 bases[i], None)
                del g
            if share_linf:
                compress_all(msgs, held, blocks_idx, bases)
                del held
            del full
            if block_plan is None:
                exchange(msgs, block_shapes, layer_targets(l))
            else:
                pending = (l, msgs)
            del msgs
        if pending is not None:   # drain: layer 0's buckets
            exchange(pending[1], block_shapes, layer_targets(pending[0]))
            pending = None

        # -- the embedding's gradient and the outer leaves -------------------
        for j in range(local):
            if cfg.input_kind == "tokens":
                emb = outer_full["embed"].detach().requires_grad_(True)
                with torch.enable_grad():
                    h0 = model.embed_stage({"embed": emb}, micro[j])
                    (g,) = torch.autograd.grad(h0, [emb], g_h[j])
                outer_message(j, "embed", g)
                del h0, emb, g
            g_h[j] = None
        if share_linf:
            compress_all(outer, [[held_outer[j][k] for k in outer_keys] for j in range(local)],
                         outer_idx, [0] * len(outer_keys))
            del held_outer
        outer_ef = ([state.ef_residual[k] for k in outer_keys] if has_ef
                    else [None] * len(outer_keys))
        exchange(outer, outer_shapes,
                 [(params[k], ef, lay, lay.axis, math.prod(s), li)
                  for k, ef, lay, s, li in zip(outer_keys, outer_ef, outer_lays, outer_shapes,
                                               outer_idx)])

        f32 = np.float32
        loss_mean = collectives.scalar_psum(torch.stack(losses), group) / f32(n_workers)
        nnz_mean = (collectives.scalar_psum(torch.stack(nnz), group) / f32(n_workers)
                    / f32(total))
        metrics = {"loss": loss_mean, "lr": torch.tensor(lr, device=dev), "nnz_frac": nnz_mean,
                   "participated": n_sel,
                   "wire_bytes_per_device": torch.tensor(f32(wire_ledger), device=dev),
                   "gather_hbm_bytes": torch.tensor(f32(gather_hbm), device=dev)}
        if count_dropped:
            metrics["nnz_dropped"] = collectives.scalar_psum(torch.stack(dropped), group)
        new_state = TrainState(params=params, ef_residual=state.ef_residual,
                               step=state.step + 1, seed=state.seed)
        return new_state, metrics

    def checkpoint_state(state: TrainState):
        """(the whole state, whether this process writes it): the slices
        gathered, written by rank 0 only."""
        whole = TrainState(params=gather_tree(state.params, layout, group),
                           ef_residual=(gather_tree(state.ef_residual, layout, group)
                                        if state.ef_residual is not None else None),
                           step=state.step, seed=state.seed)
        return whole, group.rank == 0

    step.wire = wire
    step.mode = mode
    step.ledger = (float(wire_ledger), float(gather_hbm))   # the metrics' two ledgers
    step.layout = layout
    step.state_shardings = lambda state: state_shardings(layout, state)
    step.checkpoint_state = checkpoint_state
    return step
