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

Under a tensor-parallel 'model' axis of T > 1 (JAX's step is manual over the
worker and FSDP axes and leaves 'model' to GSPMD) each device holds its
shard of its model slice of every leaf, the stages run tensor-parallel
(``models.tensor_parallel.TPModel``) and each model rank compresses,
exchanges and updates its slice of a layer as ``train/step_tp.py`` does a
leaf's (``build_streamed_train_step`` says how).
"""

from __future__ import annotations

import contextlib
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
from repro_torch.dist.sharding import TP_RULES, Placement
from repro_torch.models import tensor_parallel as tp_lib
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
    ``start``: the ``shard``-sized shards of its local workers. Under a
    'model' axis of ``parts`` > 1 ranks a leaf the placement cuts on
    ``tp_dim`` is held as this process's model ``ranks``' slices, stacked
    on a new leading axis (``step_tp``'s TP layout), each of them cut on the
    shard axis; a leaf replicated over 'model' has ``tp_dim`` None."""
    shape: Tuple[int, ...]
    axis: int
    start: int
    size: int
    shard: int
    tp_dim: Optional[int] = None
    ranks: Tuple[int, ...] = ()
    parts: int = 1

    @property
    def tp(self) -> bool:
        """Whether the leaf is cut on 'model' (held as stacked slices)."""
        return self.tp_dim is not None

    @property
    def fsdp_whole(self) -> bool:
        """Whether this process holds the whole shard axis."""
        return self.axis == REPLICATED or self.size == self.shape[self.axis]

    @property
    def whole(self) -> bool:
        """Whether this process holds the whole leaf as one tensor."""
        return self.fsdp_whole and not self.tp

    def cut(self, x: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
        """This process's shards of ``x`` along the shard axis (a view; ``x``
        itself when the process holds all of it): a whole leaf's, a model
        slice's, or with ``axis`` one layer's of a stacked leaf."""
        if self.fsdp_whole:
            return x
        return x.narrow(self.axis if axis is None else axis, self.start, self.size)

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """A whole leaf -> this process's piece of it (a copy, unless the
        process holds it whole)."""
        if self.whole:
            return x
        if self.tp:
            pieces = x.chunk(self.parts, dim=self.tp_dim)
            return torch.stack([self.cut(pieces[r]) for r in self.ranks])
        return self.cut(x).clone()

    def cut_array(self, arr: np.ndarray) -> np.ndarray:
        """``place`` for a mapped checkpoint file: only this process's
        piece is read."""
        if not self.fsdp_whole:
            arr = arr[(slice(None),) * self.axis + (slice(self.start, self.start + self.size),)]
        if self.tp:
            pieces = np.split(arr, self.parts, axis=self.tp_dim)
            arr = np.stack([pieces[r] for r in self.ranks])
        return arr


def streamed_layout(model, group: WorkerGroup) -> dict:
    """The parameter tree of ``LeafLayout``s over the group's M workers and
    its 'model' axis: the port's counterpart of JAX's ``streamed_shardings``.
    The shard axis is the same at every T (``build_fsdp_layout`` avoids the
    axes that ``TP_RULES`` places), so it never meets a leaf's model cut."""
    shapes, logical = model.param_shapes(), model.param_logical_axes()
    n, rank, local = group.n_workers, group.rank, group.local
    t = group.model_size
    placements = tp_lib.placements_for(model, t) if t > 1 else None
    ranks = tuple(group.model.ranks) if t > 1 else ()
    out = {}
    for k in shapes:
        axes = tree_leaves(build_fsdp_layout(shapes[k], n, min_axis=1 if k == "blocks" else 0,
                                             logical_tree=logical[k]))
        pls = (tree_leaves(placements[k]) if placements is not None
               else [None] * len(axes))
        lays = []
        for sd, ax, pl in zip(tree_leaves(shapes[k]), axes, pls):
            shape = tuple(sd.shape)
            tp = dict(tp_dim=pl.dim, ranks=ranks, parts=t) if pl is not None and pl.sharded \
                else {}
            assert not tp or ax != pl.dim, (k, shape, ax, pl)   # JAX's assert
            if ax == REPLICATED:
                lays.append(LeafLayout(shape, REPLICATED, 0, 0, 0, **tp))
                continue
            shard = shape[ax] // n
            lays.append(LeafLayout(shape, ax, rank * local * shard, local * shard, shard, **tp))
        out[k] = tree_unflatten(shapes[k], lays)
    return out


def shard_tree(tree, layout):
    """A tree of whole leaves cut to this process's pieces, in place: each
    dict entry of ``tree`` is replaced by its piece (a copy; a leaf the
    process holds whole is kept as it is) as it is made, so each whole leaf
    is freed at once where nothing else holds it. A T > 1 layout copies
    every cut leaf, and a second tree would hold twice the weights until the
    first one went. Returns ``tree``."""
    def walk(t, lt):
        for k in (sorted(t) if isinstance(t, dict) else range(len(t))):
            if isinstance(t[k], torch.Tensor):
                t[k] = lt[k].place(t[k])
            else:
                walk(t[k], lt[k])

    walk(tree, layout)
    return tree


def shard_state(state: TrainState, layout) -> TrainState:
    """A state of whole leaves cut to this process's slices (in place, as
    ``shard_tree``): the port's ``fsdp_param_shardings`` placement."""
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


def gather_leaf(x: torch.Tensor, lay: LeafLayout, group: WorkerGroup) -> torch.Tensor:
    """This process's piece of a leaf -> the whole leaf: its shards gathered
    over the processes, then its model slices joined (every rank of a
    worker lives in its process)."""
    if lay.whole:
        return x
    if not lay.fsdp_whole:
        x = collectives.fsdp_all_gather(x, group, lay.axis + (1 if lay.tp else 0))
    if lay.tp:
        assert len(lay.ranks) == lay.parts, lay
        x = torch.cat(list(x.unbind(0)), dim=lay.tp_dim)
    return x


def gather_tree(tree, layout, group: WorkerGroup):
    """This process's slices -> whole leaves (the leaves themselves in one
    process at T = 1)."""
    return tree_unflatten(tree, [gather_leaf(x, lay, group)
                                 for x, lay in zip(tree_leaves(tree), tree_leaves(layout))])


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

class _Messages:
    """One exchange group's messages for this process's workers: a layer's
    block leaves, or the outer leaves. ``msgs[i][r]`` and ``scales[i][r]``
    hold each worker's message and decode scale (decoded mode: its values
    and scale) of leaf i's slice r (r = 0 only for a leaf held whole on
    'model'); bucketed, ``bufs[r]`` holds local model rank r's (local, rows,
    width) buffer a bucket that each message is written into."""

    def __init__(self, plan, leaf_ranks, n_ranks: int, local: int, device,
                 zero_scales: bool = False):
        self.plan = plan
        self.msgs = [[[] for _ in range(k)] for k in leaf_ranks]
        self.scales = [[[] for _ in range(k)] for k in leaf_ranks]
        self.bufs = None
        if plan is not None:
            self.slot_of = {s.index: (bi, s) for bi, b in enumerate(plan.buckets)
                            for s in b.slots}
            self.bufs = [[torch.zeros((local, b.rows, bucketing.ROW_WIDTH[plan.fmt]),
                                      dtype=bucketing.ROW_DTYPE[plan.fmt], device=device)
                          for b in plan.buckets] for _ in range(n_ranks)]
            if zero_scales:   # the priming buckets: every decode scale 1.0
                one = torch.ones((), dtype=torch.float32, device=device)
                self.scales = [[[one] * local for _ in range(k)] for k in leaf_ranks]


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """A leaf of an exchange group as one message of a layer (or of the
    outer leaves): its whole coordinates ``n``, whether 'model' cuts it, and
    a device's share (``dev_shape``, ``dev_n``), its slice wire and its
    ranks' counter maps."""
    n: int
    sharded: bool
    dev_shape: Tuple[int, ...]
    dev_n: int
    wire: Any
    maps: tuple


def build_streamed_train_step(model, step_cfg: StreamedStepConfig,
                              group: WorkerGroup) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), ``state``
    holding this process's slices (``shard_state``). Build-time refusals
    (``ValueError``): tail blocks, tied embeddings, tau > 1.

    With a 'model' axis of T > 1 (``group.model``) each device holds its
    shard, on the worker axes, of its model slice of every leaf
    (``LeafLayout``), the stages run tensor-parallel
    (``models.tensor_parallel.TPModel``: ``embed_stage``,
    ``superblock_apply``, ``head_loss``) and each rank compresses its slice
    of a layer's gradient so its symbols are the whole layer's at the same
    coordinates, ``step_tp``'s way: the layer's counters through the slice's
    counter map at base ``l * n``, each whole-layer statistic reduced over
    'model' in rank order (``engine.leaf_slices``), a Golomb slice at its
    layer's capacity, a leaf held whole on 'model' compressed whole. Each
    rank's messages go over the worker axes and its server updates its shard
    of its slice; ``scaled_sign_ef``'s L1 is the rank-order sum of the
    ranks' worker-order sums of their shards' partials. ``bucketed=True``
    builds the two plans over a device's slices. ``wire_bytes_per_device``
    and ``gather_hbm_bytes`` bill one device's slices (JAX's figure, the
    whole leaves', is T = 1's). The model ranks of a worker must live in its
    process (``NotImplementedError`` otherwise)."""
    mg = group.model if group.model_size > 1 else None
    if mg is not None and mg.world > 1:
        raise NotImplementedError(
            f"the streamed trainer with a 'model' axis whose {mg.size} ranks span "
            f"{mg.world} processes is not ported yet: give each process whole workers")
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
    net = model.tensor_parallel(mg) if mg is not None else model   # runs the stages
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
    block_lays = tree_leaves(layout["blocks"])
    outer_lays = [layout[k] for k in outer_keys]
    n_ranks = mg.local if mg is not None else 1

    def leaf_of(shape, lay: LeafLayout, dim_shift: int) -> _Leaf:
        """A message of ``shape`` (one layer of a block leaf: its model cut
        ``dim_shift`` = 1 dim earlier than the stacked leaf's)."""
        n = math.prod(shape)
        if not lay.tp:
            return _Leaf(n, False, shape, n, wire, ())
        pl = Placement(lay.tp_dim - dim_shift, lay.parts)
        dev_shape = tuple(d // pl.parts if k == pl.dim else d for k, d in enumerate(shape))
        return _Leaf(n, True, dev_shape, n // pl.parts, wire.for_slice(n),
                     tuple(tp_lib.slice_counter_map(shape, pl, r) for r in lay.ranks))

    block_leaves = [leaf_of(tuple(sd.shape[1:]), lay, 1)
                    for sd, lay in zip(tree_leaves(shapes["blocks"]), block_lays)]
    outer_leaves = [leaf_of(tuple(shapes[k].shape), lay, 0)
                    for k, lay in zip(outer_keys, outer_lays)]
    block_ranks = [n_ranks if lf.sharded else 1 for lf in block_leaves]
    outer_ranks = [n_ranks if lf.sharded else 1 for lf in outer_leaves]
    n_rep, n_blk = cfg.n_repeats, len(block_leaves)
    total = sum(math.prod(sd.shape) for sd in tree_leaves(shapes))

    # the per-device uplink ledger: a block leaf exchanges once a layer at its
    # layer's size (a model slice's under T), an outer leaf once at its size
    # (JAX's sums, in its order)
    def exchange_bytes(lf: _Leaf) -> float:
        return collectives.uplink_ledger(mode, lf.wire, lf.dev_n, share_linf=share_linf)

    wire_ledger = sum(n_rep * exchange_bytes(lf) for lf in block_leaves)
    wire_ledger += sum(exchange_bytes(lf) for lf in outer_leaves)
    gather_hbm = 0.0
    if mode != "decoded":
        gather_hbm = max([lf.wire.gather_hbm_bytes(lf.dev_n)
                          for lf in block_leaves + outer_leaves], default=0.0)
    block_plan = outer_plan = None
    if step_cfg.bucketed:
        fmt = bucketing.wire_bucket_format(mode, wire)
        golomb = fmt == "golomb"
        rows_fn = wire.payload_rows if golomb else None

        def plan_of(leaves):
            # a device's slices; a Golomb slice's slot at its layer's capacity
            return bucketing.build_bucket_plan(
                [lf.dev_shape for lf in leaves], fmt, bucket_bytes=step_cfg.bucket_bytes,
                rows_fn=rows_fn,
                leaf_sizes=[lf.n for lf in leaves] if golomb and mg is not None else None)

        block_plan, outer_plan = plan_of(block_leaves), plan_of(outer_leaves)
        pay, scal = bucketing.streamed_plan_ledger(mode, wire, block_plan, outer_plan, n_rep,
                                                   share_linf=share_linf)
        wire_ledger = pay + scal
        gather_hbm = max(bucketing.plan_gather_hbm_bytes(mode, wire, block_plan),
                         bucketing.plan_gather_hbm_bytes(mode, wire, outer_plan))
    ring = mode != "decoded" and getattr(wire, "ring_chunk_rows", None) is not None
    n_workers, local = group.n_workers, group.local
    backend = step_cfg.backend

    def on_ranks(sharded: bool = False, r: int = 0):
        """The devices a wire call stands for in the census under T > 1: a
        slice's rank's, or every local rank's for a leaf held whole on
        'model' (or a vector over all leaves)."""
        if mg is None:
            return contextlib.nullcontext()
        return collectives.for_model_ranks((mg.offset + r,) if sharded else mg.ranks)

    def tp_psum(parts):
        return collectives.tp_sum(parts, mg)

    def tp_pmax(parts):
        return collectives.tp_max(parts, mg)

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
        # every model rank of a worker takes the worker's mask and weight
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
            """Layer l of every block leaf, gathered over the workers: a
            tensor, or under T one a local model rank."""
            out = []
            for x, lay in zip(blk, block_lays):
                if lay.tp:
                    y = x[:, l]
                    if not lay.fsdp_whole:
                        y = collectives.fsdp_all_gather(y, group, lay.axis)
                    out.append(list(y.unbind(0)))
                else:
                    out.append(x[l] if lay.whole else
                               collectives.fsdp_all_gather(x[l], group, lay.axis - 1))
            return out

        def as_blocks(leaves):
            return tree_unflatten(shapes["blocks"], leaves)

        def compress(msgs: _Messages, lf: _Leaf, j: int, i: int, g, seed_i, base, shared,
                     r: int = 0, leaf_slice=None):
            """Worker j's message of leaf i (its slice r) of a group, into
            ``msgs``."""
            slot = msgs.slot_of[i] if msgs.plan is not None else None
            if mode == "decoded":
                msg = engine.compress_leaf(g, comp, seed_i, base, backend=backend,
                                           shared_linf=shared, leaf_slice=leaf_slice)
                sc = msg.scale * w_eff[j] if part is not None else msg.scale
                if slot is None:
                    msgs.msgs[i][r].append(msg.values)
                    msgs.scales[i][r].append(sc)
                    return
                values, k = collectives.decoded_message(msg.values, sc, mask[j],
                                                        is_ternary=comp.is_ternary)
                nnz[j] = nnz[j] + k
                values = bucketing.as_rows(values, msgs.plan.fmt, slot[1].rows)
            else:
                kw = dict(backend=backend, wire=lf.wire, shared_linf=shared,
                          leaf_slice=leaf_slice)
                msg = (engine.compress_leaf(g, comp, seed_i, base, **kw) if slot is None else
                       engine.compress_leaf_rows(g, comp, seed_i, base, rows=slot[1].rows,
                                                 **kw))
                values = wire.mask_message(msg.values, mask[j])
                msgs.scales[i][r].append(msg.scale)
                nnz[j] = nnz[j] + wire.message_nnz(values)
                if count_dropped:
                    dropped[j] = dropped[j] + wire.message_dropped(values)
                if slot is None:
                    msgs.msgs[i][r].append(values)
                    return
            bi, s = slot
            # a leaf held whole on 'model' rides whole in every local rank's bucket
            for rr in ((r,) if lf.sharded else range(len(msgs.bufs))):
                msgs.bufs[rr][bi][j, s.row_start:s.row_start + s.rows] = values

        def compress_one(msgs, lf: _Leaf, j: int, i: int, g, salt, base, shared):
            """Worker j's message of leaf i of a group from its gradient ``g``
            (under T, a cut leaf's as a list of its local ranks' slices)."""
            seed_i = prng.fold_seed_int(seeds[j], salt)
            if not lf.sharded:
                compress(msgs, lf, j, i, g, seed_i, base, shared)
                return
            slices = engine.leaf_slices(comp, g, lf.maps, lf.n, psum=tp_psum, pmax=tp_pmax)
            for r, (x, lsl) in enumerate(zip(g, slices)):
                compress(msgs, lf, j, i, x, seed_i, base, shared, r, lsl)

        def compress_worker(msgs, leaves, j, src, salts, bases, shared):
            """Worker j's messages of a group from its leaves ``src``."""
            for i, (lf, g) in enumerate(zip(leaves, src)):
                compress_one(msgs, lf, j, i, g, salts[i], bases[i],
                             shared[i] if shared is not None else None)

        def compress_all(msgs, leaves, grads, salts, bases):
            """Every local worker's messages of a group under a shared L-inf:
            ``grads[j]`` holds worker j's leaves. The whole leaf's L-inf is a
            max over the model ranks, then over the sampled workers (exact
            in any order); bucketed, one vector for all leaves."""
            def linf(g):
                if isinstance(g, list):
                    return tp_pmax([torch.amax(torch.abs(x.to(torch.float32))) for x in g])
                return torch.amax(torch.abs(g.to(torch.float32)))

            with on_ranks():
                if msgs.plan is not None:
                    per = torch.stack([torch.stack([linf(g) for g in src]) for src in grads])
                    per = torch.where(mask[:, None], per, torch.zeros((), device=dev))
                    vec = group.all_reduce(torch.amax(per, dim=0),
                                           op=torch.distributed.ReduceOp.MAX)
                    shared = [vec[i] for i in range(len(salts))]
                else:
                    shared = []
                    for i in range(len(salts)):
                        per = torch.stack([linf(src[i]) for src in grads])
                        per = torch.where(mask, per, torch.zeros((), device=dev))
                        shared.append(group.all_reduce(torch.amax(per),
                                                       op=torch.distributed.ReduceOp.MAX))
            for j, src in enumerate(grads):
                compress_worker(msgs, leaves, j, src, salts, bases, shared)

        def apply(i, aggs, wtots, targets, msgs):
            """C(.) and SGD on this process's shards of leaf i of a group (of
            each local rank's slice under T), written in place."""
            ps, efs, lay, axis, size, li, sharded = targets[i]
            l1 = None
            if sharded and mode == "votes" and part is None and comp.server == "scaled_sign_ef":
                # the whole leaf's L1: each rank's shards' partials in worker
                # order, then the ranks' sums in rank order
                red = l1_reduce_of(lay, axis)
                parts = []
                for agg, ef in zip(aggs, efs):
                    n = torch.clamp(n_sel, min=1.0)
                    mag = torch.abs(lay.cut(agg, axis).to(torch.float32) / n
                                    + ef.to(torch.float32))
                    parts.append(red(mag) if red is not None else torch.sum(mag))
                l1 = tp_psum(parts)
            for r, (p, ef, agg, n_or_w) in enumerate(zip(ps, efs, aggs, wtots)):
                vs = lay.cut(agg, axis)
                wt = n_or_w if n_or_w.dim() == 0 else lay.cut(n_or_w, axis)
                if mode != "votes":
                    mean_scale = msgs.scales[i][r][-1] if mode == "scaled_votes" else None
                    new_p, new_ef = engine.server_apply(p, vs, comp, lr=lr, ef=ef, n_sel=wt,
                                                        server="mean", scale=mean_scale,
                                                        backend=backend)
                elif part is not None:
                    new_p, new_ef = engine.server_apply(p, vs, comp, lr=lr, ef=ef,
                                                        part_total=wt,
                                                        q_frac=q_frac_flat[li],
                                                        backend=backend)
                else:
                    reduce_ = ((lambda _mag, whole=l1: whole) if l1 is not None
                               else l1_reduce_of(lay, axis))
                    new_p, new_ef = engine.server_apply(
                        p, vs, comp, lr=lr, ef=ef, n_sel=n_sel, leaf_size=size,
                        l1_reduce=reduce_, quorum=quorum_flat[li], backend=backend)
                p.copy_(new_p)
                if ef is not None and new_ef is not ef:
                    ef.copy_(new_ef)

        def exchange(msgs: _Messages, leaves, targets):
            """One exchange a leaf (a slice a rank) or a bucket (one a rank),
            then the servers; ``targets`` None drops the sums (the priming
            buckets)."""
            nonlocal nnz
            if msgs.plan is None:
                for i, lf in enumerate(leaves):
                    aggs, wtots = [], []
                    for r in range(len(msgs.msgs[i])):
                        stack = msgs.msgs[i][r] if ring else torch.stack(msgs.msgs[i][r])
                        msgs.msgs[i][r] = None
                        with on_ranks(lf.sharded, r):
                            if mode == "decoded":
                                agg, k = collectives.decoded_exchange(
                                    stack, torch.stack(msgs.scales[i][r]), mask, group,
                                    is_ternary=comp.is_ternary)
                                nnz = [a + b for a, b in zip(nnz, k)]
                                n_or_w = n_dec
                            else:
                                wire_scale = (torch.stack(msgs.scales[i][r]) if mode == "pack8"
                                              else None)
                                if part is not None:
                                    agg, n_or_w = wire.exchange_weighted(
                                        stack, lf.dev_n, lf.dev_shape, weight=w_eff,
                                        scale=wire_scale)
                                else:
                                    agg = wire.exchange(stack, lf.dev_n, lf.dev_shape,
                                                        scale=wire_scale)
                                    n_or_w = n_sel
                        del stack
                        aggs.append(agg)
                        wtots.append(n_or_w)
                        del agg
                    apply(i, aggs, wtots, targets, msgs)
                    del aggs
                return
            n_bufs = len(msgs.bufs)
            for bi, b in enumerate(msgs.plan.buckets):
                got = []   # each local rank's (per-slot sums, W)
                for r in range(n_bufs):
                    buf, msgs.bufs[r][bi] = msgs.bufs[r][bi], None
                    bscale = None
                    if mode == "pack8":   # (local, n_slots): each worker's slot scales
                        bscale = torch.stack([torch.stack([
                            msgs.scales[s.index][r if leaves[s.index].sharded else 0][j]
                            for s in b.slots]) for j in range(local)])
                    with on_ranks(True, r):
                        if mode == "decoded":
                            got.append((bucketing.split_bucket(
                                collectives.decoded_exchange_bucket(buf, group), b), n_dec))
                        elif part is not None:
                            got.append(wire.exchange_bucket_weighted(buf, b, weight=w_eff,
                                                                     scale=bscale))
                        else:
                            got.append((wire.exchange_bucket(buf, b, scale=bscale), n_sel))
                    del buf
                if targets is not None:
                    for k, s in enumerate(b.slots):
                        rs = range(n_bufs) if leaves[s.index].sharded else range(1)
                        apply(s.index, [got[r][0][k] for r in rs],
                              [got[r][1][k] if isinstance(got[r][1], list) else got[r][1]
                               for r in rs], targets, msgs)
                del got

        def layer_targets(l: int) -> list:
            out = []
            for x, ef, lay, lf, li in zip(blk, blk_ef, block_lays, block_leaves, blocks_idx):
                axis = lay.axis - 1 if lay.axis != REPLICATED else REPLICATED
                if lay.tp:
                    ps = list(x[:, l].unbind(0))
                    efs = list(ef[:, l].unbind(0)) if ef is not None else [None] * len(ps)
                else:
                    ps, efs = [x[l]], [ef[l] if ef is not None else None]
                out.append((ps, efs, lay, axis, lf.n, li, lay.tp))
            return out

        def grad_leaves(full):
            """Fresh leaves of a layer's parameters that take gradients (a
            cut leaf's slices each), and the flat list of them."""
            ps = [[x.detach().requires_grad_(True) for x in f] if isinstance(f, list)
                  else f.detach().requires_grad_(True) for f in full]
            return ps, [x for f in ps for x in (f if isinstance(f, list) else [f])]

        def regroup(flat, like):
            it = iter(flat)
            return [[next(it) for _ in f] if isinstance(f, list) else next(it) for f in like]

        # -- forward: every worker block by block, each block's input kept --
        def outer_whole(k, lay):
            x = params[k]
            if lay.fsdp_whole:
                return x
            return collectives.fsdp_all_gather(x, group, lay.axis + (1 if lay.tp else 0))

        outer_full = {k: outer_whole(k, lay) for k, lay in zip(outer_keys, outer_lays)}
        hs, inputs = [], [[None] * n_rep for _ in range(local)]
        pos = [(mb["positions"], mb.get("positions3")) for mb in micro]
        with torch.no_grad():
            for j in range(local):
                hs.append(net.embed_stage(outer_full, micro[j]))
            for l in range(n_rep):
                full = as_blocks(full_layer(l))
                for j in range(local):
                    inputs[j][l] = hs[j]
                    hs[j] = net.superblock_apply(full, hs[j], *pos[j])
                del full

        # -- head: loss and the head leaves' and h's gradients; each
        # worker's head messages at once (held under a shared L-inf) --------
        outer = _Messages(outer_plan, outer_ranks, n_ranks, local, dev)
        held_outer = [dict() for _ in range(local)]
        losses, g_h = [], []

        def outer_message(j: int, k: str, g):
            if layout[k].tp:   # a cut outer leaf's gradient: its local ranks' slices
                g = list(g.unbind(0))
            if share_linf:
                held_outer[j][k] = g
            else:
                i = outer_keys.index(k)
                compress_one(outer, outer_leaves[i], j, i, g, outer_idx[i], 0, None)

        for j in range(local):
            hp = {k: outer_full[k].detach().requires_grad_(True) for k in head_keys}
            hf = hs[j].detach().requires_grad_(True)
            hs[j] = None
            with torch.enable_grad():
                loss = net.head_loss(hp, rms_norm(hf, hp["final_norm"], cfg.norm_eps),
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
            pending = (None, _Messages(block_plan, block_ranks, n_ranks, local, dev,
                                       zero_scales=True))
        for l in reversed(range(n_rep)):
            if pending is not None:
                lp, msgs = pending
                exchange(msgs, block_leaves, layer_targets(lp) if lp is not None else None)
                pending = None
            full = full_layer(l)
            msgs = _Messages(block_plan, block_ranks, n_ranks, local, dev)
            bases = [(l * lf.n) & prng.MASK32 for lf in block_leaves]
            held = []
            for j in range(local):
                ps, flat = grad_leaves(full)
                h_in = inputs[j][l].detach().requires_grad_(True)
                inputs[j][l] = None
                with torch.enable_grad():
                    out = net.superblock_apply(as_blocks(ps), h_in, *pos[j])
                    grads = torch.autograd.grad(out, flat + [h_in], g_h[j], allow_unused=True)
                g_h[j] = grads[-1]
                g = regroup([gi if gi is not None else torch.zeros_like(p)
                             for gi, p in zip(grads, flat)], ps)
                del grads, out, ps, flat, h_in
                if share_linf:
                    held.append(g)
                else:
                    compress_worker(msgs, block_leaves, j, g, blocks_idx, bases, None)
                del g
            if share_linf:
                compress_all(msgs, block_leaves, held, blocks_idx, bases)
                del held
            del full
            if block_plan is None:
                exchange(msgs, block_leaves, layer_targets(l))
            else:
                pending = (l, msgs)
            del msgs
        if pending is not None:   # drain: layer 0's buckets
            exchange(pending[1], block_leaves, layer_targets(pending[0]))
            pending = None

        # -- the embedding's gradient and the outer leaves -------------------
        for j in range(local):
            if cfg.input_kind == "tokens":
                emb = outer_full["embed"].detach().requires_grad_(True)
                with torch.enable_grad():
                    h0 = net.embed_stage({"embed": emb}, micro[j])
                    (g,) = torch.autograd.grad(h0, [emb], g_h[j])
                outer_message(j, "embed", g)
                del h0, emb, g
            g_h[j] = None
        if share_linf:
            compress_all(outer, outer_leaves,
                         [[held_outer[j][k] for k in outer_keys] for j in range(local)],
                         outer_idx, [0] * len(outer_keys))
            del held_outer
        outer_ef = ([state.ef_residual[k] for k in outer_keys] if has_ef
                    else [None] * len(outer_keys))

        def outer_target(k, ef, lay, lf, li):
            x = params[k]
            if lay.tp:
                ps = list(x.unbind(0))
                efs = list(ef.unbind(0)) if ef is not None else [None] * len(ps)
            else:
                ps, efs = [x], [ef]
            return ps, efs, lay, lay.axis, lf.n, li, lay.tp

        exchange(outer, outer_leaves,
                 [outer_target(k, ef, lay, lf, li) for k, ef, lay, lf, li
                  in zip(outer_keys, outer_ef, outer_lays, outer_leaves, outer_idx)])

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

    def whole_state(state: TrainState) -> TrainState:
        """This process's slices gathered into whole leaves."""
        return TrainState(params=gather_tree(state.params, layout, group),
                          ef_residual=(gather_tree(state.ef_residual, layout, group)
                                       if state.ef_residual is not None else None),
                          step=state.step, seed=state.seed)

    def checkpoint_state(state: TrainState):
        """(the whole state, whether this process writes it): the slices
        gathered, written by rank 0 only."""
        return whole_state(state), group.rank == 0

    step.wire = wire
    step.mode = mode
    step.share_linf = share_linf
    step.ledger = (float(wire_ledger), float(gather_hbm))   # the metrics' two ledgers
    step.layout = layout
    step.plans = (block_plan, outer_plan)
    step.n_repeats = n_rep
    step.tp_model = net if mg is not None else None
    step.shard_state = lambda state: shard_state(state, layout)
    step.whole_state = whole_state
    step.state_shardings = lambda state: state_shardings(layout, state)
    step.checkpoint_state = checkpoint_state
    return step
