"""The `simple` train step with a tensor-parallel 'model' axis, the port of
``repro.train.step_simple`` on a (workers..., 'model') mesh.

JAX's step is manual over the worker axes and GSPMD over 'model': every
device of a worker holds its slice of each leaf that ``TP_RULES`` places on
'model' and a replica of the rest, the model runs Megatron-style, and the
compressors see the whole logical leaf. Here each model rank of a worker
(``collectives.ModelGroup``, a leading dimension of the process, over
``torch.distributed`` when the ranks span processes):

  1. computes the worker's gradient in the TP layout
     (``model.tensor_parallel(mg)``: ``models.tensor_parallel.TPModel``),
     or with tau > 1 local steps (Alg. 2) the sum of its compressed local
     steps, each slice drawing the whole leaf's counters;
  2. compresses each slice so its symbols are the whole leaf's at the same
     coordinates: the kernels draw the whole leaf's counters (the counter
     map, ``tensor_parallel.slice_counter_map``), and every statistic of the
     whole leaf is reduced over 'model' from the slices' partials
     (``engine.leaf_slices``: the L2 budget's and the L2 scales' sums of
     squares and scaled sign's L1 in rank order, 1-bit QSGD's L-inf max,
     ``target_sparsity``'s bisection, one ordered sum an iteration), TernGrad's
     and ``linf_share``'s shared L-inf is a max over the ranks and the
     workers; a replicated leaf is compressed whole, as a device of JAX's
     mesh compresses it;
  3. exchanges each slice's messages over the worker axes (its own
     canonical packed view on the gather wires, its own Golomb stream, sized
     by the whole leaf's capacity, on the golomb wire) and updates only its
     slice; ``scaled_sign_ef``'s L1 is the ordered sum of the slices'
     partials. Under elastic participation every rank of a worker takes the
     worker's mask and weight, and each slice's weighted exchange gives the
     same W.

``bucketed=True``: each model rank of a worker has its own bucket buffers
over ONE slice plan (``bucketing.build_bucket_plan`` over a device's leaves
in flat leaf order: a sharded leaf's slot is its slice, a Golomb slot sized
by its whole leaf's capacity, a replicated leaf's slot the whole leaf).
Each slice's message goes straight into its slot of its rank's buffer; a
replicated leaf's message rides whole in every local rank's bucket, as a
device of JAX's mesh sends it, and one rank's sum updates it. One exchange
a bucket a rank replaces the per-leaf ones; the shared L-inf is one vector
for all leaves. ``ring_chunk_rows`` makes a gather wire the chunked ring,
per leaf (the workers' messages unstacked) or over a rank's bucket; a
slice's wire keeps it (``VoteWire.for_slice``).

``wire_bytes_per_device`` bills what one device sends: per leaf, each
sharded leaf's slice ledger and each replicated leaf's whole one; bucketed,
the slice plan's ``plan_ledger``. JAX's step reports the whole leaves'
ledger (``g.size`` inside a ``shard_map`` manual over the worker axes
only).

Every ``TrainStepConfig`` of the T = 1 step runs, on every ``simple``-mode
family: a stacked expert leaf is cut on its expert axis (dim 1), mamba2's
``conv_x`` on its last (dim 2), and both take the same slice maps, wires,
buckets, rings and checkpoint layouts as any cut leaf. The streamed
trainer's T > 1 step is ``train/step_streamed.py``'s, on the same model
stages. Not ported yet under T > 1, raising elsewhere: what
``models.tensor_parallel`` refuses (heads or experts T does not divide).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine, prng
from repro_torch.core.algorithm import worker_stream_seed
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.dist import bucketing, collectives
from repro_torch.dist.collectives import WorkerGroup
from repro_torch.models import tensor_parallel as tp_lib
from repro_torch.train import sampling
from repro_torch.train.state import TrainState
from repro_torch.train.step_simple import worker_batch

LOCAL_LEAF_SALT = 7000   # step_simple's: the tau local steps' per-leaf streams


@dataclasses.dataclass(frozen=True)
class TPLeafLayout:
    """A TP-layout leaf's place in the whole leaf, for ``checkpoint.restore``:
    the whole ``shape``, the cut ``axis``, this process's ranks' block
    (``size`` indices from ``start``), restored as ``pieces`` stacked slices."""

    shape: tuple
    axis: int
    start: int
    size: int
    pieces: int

    @property
    def whole(self) -> bool:
        return False

    def cut_array(self, arr: np.ndarray) -> np.ndarray:
        """This process's block of a mapped whole leaf, as its stacked model
        slices."""
        arr = arr[(slice(None),) * self.axis + (slice(self.start, self.start + self.size),)]
        return np.stack(np.split(arr, self.pieces, axis=self.axis))


def build_tp_train_step(model, step_cfg, group: WorkerGroup):
    """The step of ``step_simple.build_train_step`` for a group with a
    'model' axis of size T > 1. ``state.params`` and the EF residual are in
    the TP layout (``step.shard_state`` cuts a whole state to it)."""
    mg = group.model
    comp = step_cfg.compression
    tpm = model.tensor_parallel(mg)
    placements = tpm.placements
    pls = tree_leaves(placements)
    shapes = [tuple(sd.shape) for sd in tree_leaves(model.param_shapes())]
    numels = [int(np.prod(s)) for s in shapes]
    maps = [[tp_lib.slice_counter_map(s, pl, r) for r in mg.ranks] for s, pl in zip(shapes, pls)]
    dev_numel = [n // pl.parts if pl.sharded else n for n, pl in zip(numels, pls)]
    dev_shapes = [tuple(d // pl.parts if pl.sharded and k == pl.dim else d
                        for k, d in enumerate(s)) for s, pl in zip(shapes, pls)]
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
    # a slice's wire: the golomb capacity of a slice is its whole leaf's
    leaf_wires = [wire.for_slice(n) if pl.sharded else wire for n, pl in zip(numels, pls)]
    plan = None
    if step_cfg.bucketed:
        fmt = bucketing.wire_bucket_format(mode, wire)
        golomb = fmt == "golomb"
        plan = bucketing.build_bucket_plan(
            dev_shapes, fmt, bucket_bytes=step_cfg.bucket_bytes,
            rows_fn=wire.payload_rows if golomb else None, leaf_sizes=numels if golomb else None)
        # leaf i's (bucket, slot): the plan is in leaf order
        slot_of = {s.index: (bi, s) for bi, b in enumerate(plan.buckets) for s in b.slots}
    # the per-leaf ring takes the workers' messages as they are, unstacked
    ring = mode != "decoded" and getattr(wire, "ring_chunk_rows", None) is not None
    count_dropped = wire.native_format == "golomb"
    share_linf = engine.needs_shared_linf(comp)
    if mode != "votes" and engine.needs_server_ef(comp.server):
        raise ValueError(f"server {comp.server!r} needs the integer vote wire, but compressor "
                         f"{comp.compressor!r} rides the {mode!r} wire")
    quorum_leaves = tree_leaves(engine.broadcast_quorum(step_cfg.quorum, model.param_shapes()))
    q_fracs = ([part.resolve_q_frac(q, wire.n_workers) for q in quorum_leaves]
               if part is not None else None)
    if mode != "votes" and any(q != 1 for q in quorum_leaves):
        raise ValueError(f"quorum={step_cfg.quorum!r} is a vote-server deadband; compressor "
                         f"{comp.compressor!r} rides the {mode!r} wire")
    n_workers = group.n_workers
    batch_axis = 1 if comp.local_steps > 1 else 0
    backend = step_cfg.backend
    first_rank = mg.offset == 0   # counts the replicated leaves' metrics once

    def psum(parts):
        return collectives.tp_sum(parts, mg)

    def pmax(parts):
        return collectives.tp_max(parts, mg)

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = tpm.loss(tree_unflatten(params, leaves), batch)[0]
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    def local_grads(params, batch, wseed):
        """(loss, message sources in the TP layout): step_simple's
        ``_local_grads`` on slices."""
        tau = comp.local_steps
        if tau == 1:
            return grads_of(params, batch)
        local_cfg = engine.local_step_config(comp)
        w = tree_leaves(params)
        acc = [torch.zeros(p.shape, dtype=torch.int32, device=p.device) for p in w]
        losses = []
        for c in range(tau):
            loss, grads = grads_of(tree_unflatten(params, w), {k: v[c] for k, v in batch.items()})
            losses.append(loss)
            for i, g in enumerate(grads):
                seed = prng.fold_seed_int(wseed, LOCAL_LEAF_SALT + i)
                base = (c * numels[i]) & prng.MASK32
                if pls[i].sharded:
                    q = torch.stack([engine.compress_leaf(
                        g[r], local_cfg, seed, base, backend=backend,
                        leaf_slice=engine.LeafSlice(maps[i][r], numels[i])).values
                        for r in range(mg.local)])
                else:
                    q = engine.compress_leaf(g, local_cfg, seed, base, backend=backend).values
                eta = torch.full((), float(step_cfg.local_lr), dtype=w[i].dtype,
                                 device=w[i].device)
                w[i] = w[i] - eta * q.to(w[i].dtype)
                acc[i] += q.to(torch.int32)
        return torch.mean(torch.stack(losses)), [a.to(torch.float32) for a in acc]

    def step(state: TrainState, batch: dict):
        params = state.params
        p_leaves = tree_leaves(params)
        dev = p_leaves[0].device
        widx = collectives.worker_index(group, dev)
        rseed = sampling.round_seed(state.seed, state.step)
        mask = sampling.participation_mask(rseed, state.step, widx, comp.worker_sample_fraction)
        w_eff = None
        if part is not None:
            # the worker's reporting bit and weight, the same on each of its
            # model ranks (keyed by the worker's index, never drawn a rank)
            mask = mask & sampling.report_mask(rseed, state.step, widx, part.dropout)
            w_eff = part.weights_array(n_workers, dev)[widx] * mask.to(torch.float32)
        lr = step_cfg.lr(state.step)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        n_leaves = len(p_leaves)
        # msgs[i][r]: local rank r's messages of leaf i, one a local worker
        # (a replicated leaf: r = 0 only); bucketed, bufs[r][b] is local rank
        # r's (local, rows, width) buffer of bucket b
        msgs = [[[] for _ in range(mg.local if pl.sharded else 1)] for pl in pls]
        scales = [[[] for _ in range(mg.local if pl.sharded else 1)] for pl in pls]
        bufs = ([[torch.zeros((group.local, b.rows, bucketing.ROW_WIDTH[plan.fmt]),
                              dtype=bucketing.ROW_DTYPE[plan.fmt], device=dev)
                  for b in plan.buckets] for _ in range(mg.local)]
                if plan is not None else None)
        nnz = [[zero] * mg.local for _ in range(group.local)]
        dropped = [[zero] * mg.local for _ in range(group.local)]
        losses, sources, seeds = [], [], []

        def compress_worker(j, src, shared):
            for i, g in enumerate(src):
                seed_i = prng.fold_seed_int(seeds[j], i)
                sh = shared[i] if shared is not None else None
                sharded = pls[i].sharded
                if sharded:
                    slices = engine.leaf_slices(comp, list(g.unbind(0)), maps[i], numels[i],
                                                psum=psum, pmax=pmax)
                    parts = [(r, g[r], slices[r]) for r in range(mg.local)]
                else:
                    parts = [(0, g, None)]
                counted = sharded or first_rank   # a replicated leaf's metrics once
                slot = slot_of[i] if plan is not None else None
                for r, x, lsl in parts:
                    if mode == "decoded":
                        msg = engine.compress_leaf(x, comp, seed_i, backend=backend,
                                                   shared_linf=sh, leaf_slice=lsl)
                        # elastic: the weight premultiplies the decode scale
                        sc = msg.scale * w_eff[j] if part is not None else msg.scale
                        if slot is None:
                            scales[i][r].append(sc)
                            msgs[i][r].append(msg.values)
                            continue
                        values, k = collectives.decoded_message(msg.values, sc, mask[j],
                                                                is_ternary=comp.is_ternary)
                        if counted:
                            nnz[j][r] = nnz[j][r] + k
                        values = bucketing.as_rows(values, plan.fmt, slot[1].rows)
                    else:
                        kw = dict(backend=backend, wire=leaf_wires[i], shared_linf=sh,
                                  leaf_slice=lsl)
                        msg = (engine.compress_leaf(x, comp, seed_i, **kw) if slot is None else
                               engine.compress_leaf_rows(x, comp, seed_i, rows=slot[1].rows,
                                                         **kw))
                        scales[i][r].append(msg.scale)
                        values = wire.mask_message(msg.values, mask[j])
                        if counted:
                            nnz[j][r] = nnz[j][r] + wire.message_nnz(values)
                            if count_dropped:
                                dropped[j][r] = dropped[j][r] + wire.message_dropped(values)
                        if slot is None:
                            msgs[i][r].append(values)
                            continue
                    bi, s = slot
                    # a replicated leaf rides whole in every local rank's bucket
                    for rr in ((r,) if sharded else range(mg.local)):
                        bufs[rr][bi][j, s.row_start:s.row_start + s.rows] = values
                    del values   # the slots hold it now

        for j in range(group.local):
            w = group.rank * group.local + j
            seeds.append(worker_stream_seed(rseed, w))
            micro = worker_batch(batch, w, n_workers, batch_axis, dev)
            loss, src = local_grads(params, micro, seeds[j])
            losses.append(loss)
            if share_linf:
                sources.append(src)
            else:
                compress_worker(j, src, None)
            del src
        if share_linf:
            # the whole leaf's L-inf: a max over the model ranks, then over
            # the sampled workers (exact in any order); bucketed, one vector
            # for all leaves
            def rank_max(x, pl, r):
                return torch.amax(torch.abs((x[r] if pl.sharded else x).to(torch.float32)))

            if plan is not None:
                local = torch.stack([pmax([torch.stack([rank_max(x, pl, r)
                                                        for x, pl in zip(s, pls)])
                                           for r in range(mg.local)]) for s in sources])
                local = torch.where(mask[:, None], local, torch.zeros((), device=dev))
                with collectives.for_model_ranks(mg.ranks):
                    shared = group.all_reduce(torch.amax(local, dim=0),
                                              op=torch.distributed.ReduceOp.MAX)
            else:
                shared = []
                for i, pl in enumerate(pls):
                    local = torch.stack([pmax([rank_max(s[i], pl, r) for r in range(mg.local)])
                                         if pl.sharded else rank_max(s[i], pl, 0)
                                         for s in sources])
                    local = torch.where(mask, local, torch.zeros((), device=dev))
                    with collectives.for_model_ranks(mg.ranks):
                        shared.append(group.all_reduce(torch.amax(local),
                                                       op=torch.distributed.ReduceOp.MAX))
            for j in range(group.local):
                compress_worker(j, sources[j], shared)
                sources[j] = None

        n_sel = collectives.scalar_psum(mask.to(torch.float32), group)
        if mode == "decoded":   # the mean's divisor: W (one protocol scalar) or n_sel
            n_dec = collectives.scalar_psum(w_eff, group) if part is not None else n_sel
        ef_flat = (tree_leaves(state.ef_residual) if state.ef_residual is not None
                   else [None] * n_leaves)

        def apply(i, aggs, wtots):
            """C(.) and SGD on leaf i from its ranks' exchanged sums (one a
            local rank of a sharded leaf, one for a replicated leaf), written
            in place."""
            p = p_leaves[i]
            sharded = pls[i].sharded
            views = list(p.unbind(0)) if sharded else [p]
            efs = (list(ef_flat[i].unbind(0)) if sharded else [ef_flat[i]]) \
                if ef_flat[i] is not None else [None] * len(views)
            l1 = None
            if sharded and comp.server == "scaled_sign_ef" and mode == "votes":
                # the whole leaf's L1: the slices' partials in rank order
                l1 = psum([engine.ef_l1_partial(a, e, n_sel) for a, e in zip(aggs, efs)])
            for r, (pr, agg, ef, n_or_w) in enumerate(zip(views, aggs, efs, wtots)):
                if mode != "votes":
                    mean_scale = scales[i][r][-1] if mode == "scaled_votes" else None
                    new_p, new_ef = engine.server_apply(pr, agg, comp, lr=lr, ef=ef,
                                                        n_sel=n_or_w, server="mean",
                                                        scale=mean_scale, backend=backend)
                elif part is not None:
                    new_p, new_ef = engine.server_apply(pr, agg, comp, lr=lr, ef=ef,
                                                        part_total=n_or_w, q_frac=q_fracs[i],
                                                        backend=backend)
                else:
                    new_p, new_ef = engine.server_apply(
                        pr, agg, comp, lr=lr, ef=ef, n_sel=n_sel, quorum=quorum_leaves[i],
                        leaf_size=numels[i] if l1 is not None else None,
                        l1_reduce=(lambda _mag, total=l1: total) if l1 is not None else None,
                        backend=backend)
                pr.copy_(new_p)
                if ef is not None and new_ef is not ef:
                    ef.copy_(new_ef)

        if plan is not None:
            for bi, b in enumerate(plan.buckets):
                got = []   # each local rank's (per-slot sums, W)
                for r in range(mg.local):
                    buf, bufs[r][bi] = bufs[r][bi], None
                    bscale = None
                    if mode == "pack8":   # (local, n_slots): each worker's slot scales
                        bscale = torch.stack([torch.stack([
                            scales[s.index][r if pls[s.index].sharded else 0][j]
                            for s in b.slots]) for j in range(group.local)])
                    # the census bills each rank's bucket to its own device
                    with collectives.for_model_ranks((mg.offset + r,)):
                        if mode == "decoded":
                            got.append((bucketing.split_bucket(
                                collectives.decoded_exchange_bucket(buf, group), b), n_dec))
                        elif part is not None:
                            # W is per slot (per coordinate) on the psum wires,
                            # one scalar on the gather wires
                            got.append(wire.exchange_bucket_weighted(buf, b, weight=w_eff,
                                                                     scale=bscale))
                        else:
                            got.append((wire.exchange_bucket(buf, b, scale=bscale), n_sel))
                    del buf
                for k, s in enumerate(b.slots):
                    ranks = range(mg.local) if pls[s.index].sharded else range(1)
                    apply(s.index, [got[r][0][k] for r in ranks],
                          [got[r][1][k] if isinstance(got[r][1], list) else got[r][1]
                           for r in ranks])
                del got
            pay, scal = bucketing.plan_ledger(mode, wire, plan, share_linf=share_linf)
            wire_bytes = pay + scal
            gather_hbm = bucketing.plan_gather_hbm_bytes(mode, wire, plan)
        else:
            wire_bytes, gather_hbm = 0.0, 0.0
            for i, p in enumerate(p_leaves):
                n_dev = dev_numel[i]
                wire_bytes += collectives.uplink_ledger(mode, leaf_wires[i], n_dev,
                                                        share_linf=share_linf)
                if mode != "decoded":
                    gather_hbm = max(gather_hbm, leaf_wires[i].gather_hbm_bytes(n_dev))
                sharded = pls[i].sharded
                aggs, wtots = [], []
                for r, pr in enumerate(p.unbind(0) if sharded else [p]):
                    stack = msgs[i][r] if ring else torch.stack(msgs[i][r])
                    msgs[i][r] = None
                    # the census bills a slice's exchange to its rank's device, a
                    # replicated leaf's to every local rank's
                    with collectives.for_model_ranks((mg.offset + r,) if sharded else mg.ranks):
                        if mode == "decoded":
                            agg, k = collectives.decoded_exchange(
                                stack, torch.stack(scales[i][r]), mask, group,
                                is_ternary=comp.is_ternary)
                            n_or_w = n_dec
                            if sharded or first_rank:
                                for j in range(group.local):
                                    nnz[j][r] = nnz[j][r] + k[j]
                        else:
                            wire_scale = torch.stack(scales[i][r]) if mode == "pack8" else None
                            if part is not None:
                                agg, n_or_w = wire.exchange_weighted(
                                    stack, pr.numel(), tuple(pr.shape), weight=w_eff,
                                    scale=wire_scale)
                            else:
                                agg, n_or_w = wire.exchange(stack, pr.numel(), tuple(pr.shape),
                                                            scale=wire_scale), n_sel
                    del stack
                    aggs.append(agg)
                    wtots.append(n_or_w)
                apply(i, aggs, wtots)
                del aggs

        f32 = np.float32
        total = sum(numels)
        loss_mean = collectives.scalar_psum(torch.stack(losses), group) / f32(n_workers)
        worker_nnz = torch.stack([psum(nnz[j]) for j in range(group.local)])
        nnz_mean = (collectives.scalar_psum(worker_nnz, group) / f32(n_workers) / f32(total))
        metrics = {"loss": loss_mean, "lr": torch.tensor(lr, device=dev), "nnz_frac": nnz_mean,
                   "participated": n_sel,
                   "wire_bytes_per_device": torch.tensor(f32(wire_bytes), device=dev),
                   "gather_hbm_bytes": torch.tensor(f32(gather_hbm), device=dev)}
        if count_dropped:
            metrics["nnz_dropped"] = collectives.scalar_psum(
                torch.stack([psum(dropped[j]) for j in range(group.local)]), group)
        return TrainState(params=params, ef_residual=state.ef_residual, step=state.step + 1,
                          seed=state.seed), metrics

    def shard_state(state: TrainState) -> TrainState:
        """A state of whole leaves cut to this process's model slices."""
        return TrainState(params=tp_lib.shard_tree(state.params, placements, mg),
                          ef_residual=(tp_lib.shard_tree(state.ef_residual, placements, mg)
                                       if state.ef_residual is not None else None),
                          step=state.step, seed=state.seed)

    def whole_state(state: TrainState) -> TrainState:
        """This process's slices gathered into whole leaves."""
        return TrainState(params=tp_lib.gather_tree(state.params, placements, mg),
                          ef_residual=(tp_lib.gather_tree(state.ef_residual, placements, mg)
                                       if state.ef_residual is not None else None),
                          step=state.step, seed=state.seed)

    def checkpoint_state(state: TrainState):
        """(the whole state, whether this process writes it): process 0 of
        the default group writes, every process gathers."""
        whole = whole_state(state)
        rank = (torch.distributed.get_rank() if torch.distributed.is_available()
                and torch.distributed.is_initialized() else 0)
        return whole, rank == 0

    def state_shardings(state: TrainState) -> TrainState:
        """``checkpoint.restore``'s layouts for the TP state: the process's
        block of each cut leaf, restored as its stacked slices."""
        lays = []
        for shape, pl in zip(shapes, pls):
            if not pl.sharded:
                lays.append(None)
                continue
            size = shape[pl.dim] // pl.parts
            lays.append(TPLeafLayout(shape, pl.dim, mg.offset * size, mg.local * size,
                                     mg.local))
        lay = tree_unflatten(model.param_shapes(), lays)
        return TrainState(params=lay, ef_residual=lay if state.ef_residual is not None else None,
                          step=None, seed=None)

    step.wire = wire
    step.mode = mode
    step.share_linf = share_linf
    step.plan = plan
    step.placements = placements
    step.tp_model = tpm
    step.shard_state = shard_state
    step.whole_state = whole_state
    step.checkpoint_state = checkpoint_state
    step.state_shardings = state_shardings
    return step

