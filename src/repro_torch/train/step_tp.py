"""The `simple` train step with a tensor-parallel 'model' axis, the port of
``repro.train.step_simple`` on a (workers..., 'model') mesh.

JAX's step is manual over the worker axes and GSPMD over 'model': every
device of a worker holds its slice of each leaf that ``TP_RULES`` places on
'model' and a replica of the rest, the model runs Megatron-style, and the
compressors see the whole logical leaf. Here each model rank of a worker
(``collectives.ModelGroup``, a leading dimension of the process, over
``torch.distributed`` when the ranks span processes):

  1. computes the worker's gradient in the TP layout
     (``model.tensor_parallel(mg)``: ``models.tensor_parallel.TPModel``);
  2. compresses each slice so its symbols are the whole leaf's at the same
     coordinates: the kernels draw the whole leaf's counters (the counter
     map, ``tensor_parallel.slice_counter_map``), and a statistic of the
     whole leaf (the L2 budget's and qsgd8's sum of squares in rank order,
     TernGrad's L-inf max) is reduced over 'model'; a replicated leaf is
     compressed whole, as a device of JAX's mesh compresses it;
  3. exchanges each slice's messages over the worker axes (its own
     canonical packed view on the gather wires) and updates only its slice;
     ``scaled_sign_ef``'s L1 is the ordered sum of the slices' partials.

``wire_bytes_per_device`` bills what one device sends: each sharded leaf's
slice ledger and each replicated leaf's whole one. JAX's step reports the
whole leaves' ledger (``g.size`` inside a ``shard_map`` manual over the
worker axes only).

Not ported yet under T > 1, each raising: the bucketed uplink, the ring,
elastic participation, the Golomb wire, ``target_sparsity`` and every
(compressor, wire) pair outside ``engine.TP_COMPRESSORS``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine, prng
from repro_torch.core.algorithm import worker_stream_seed
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.dist import collectives
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


def check_supported(step_cfg) -> None:
    """Raise for what the tensor-parallel step does not port yet."""
    comp = step_cfg.compression
    for flag, what in ((step_cfg.bucketed, "the bucketed uplink"),
                       (step_cfg.ring_chunk_rows is not None, "the ring gather"),
                       (step_cfg.participation is not None, "elastic participation")):
        if flag:
            raise tp_lib.not_ported(what)
    engine.check_tensor_parallel(comp, step_cfg.vote_impl)


def build_tp_train_step(model, step_cfg, group: WorkerGroup):
    """The step of ``step_simple.build_train_step`` for a group with a
    'model' axis of size T > 1. ``state.params`` and the EF residual are in
    the TP layout (``step.shard_state`` cuts a whole state to it)."""
    check_supported(step_cfg)
    mg = group.model
    comp = step_cfg.compression
    tpm = model.tensor_parallel(mg)
    placements = tpm.placements
    pls = tree_leaves(placements)
    shapes = [tuple(sd.shape) for sd in tree_leaves(model.param_shapes())]
    numels = [int(np.prod(s)) for s in shapes]
    maps = [[tp_lib.slice_counter_map(s, pl, r) for r in mg.ranks] for s, pl in zip(shapes, pls)]
    dev_numel = [n // pl.parts if pl.sharded else n for n, pl in zip(numels, pls)]
    mode = engine.wire_mode(comp, vote_impl=step_cfg.vote_impl)
    wire_fmt = engine.wire_payload_format(comp, mode, vote_impl=step_cfg.vote_impl)
    wire = collectives.make_vote_wire(step_cfg.vote_impl, group, backend=step_cfg.backend,
                                      wire_format=wire_fmt)
    share_linf = engine.needs_shared_linf(comp)
    need_sq = engine.needs_leaf_sum_sq(comp)
    if mode != "votes" and engine.needs_server_ef(comp.server):
        raise ValueError(f"server {comp.server!r} needs the integer vote wire, but compressor "
                         f"{comp.compressor!r} rides the {mode!r} wire")
    quorum_leaves = tree_leaves(engine.broadcast_quorum(step_cfg.quorum, model.param_shapes()))
    if mode != "votes" and any(q != 1 for q in quorum_leaves):
        raise ValueError(f"quorum={step_cfg.quorum!r} is a vote-server deadband; compressor "
                         f"{comp.compressor!r} rides the {mode!r} wire")
    n_workers = group.n_workers
    batch_axis = 1 if comp.local_steps > 1 else 0
    backend = step_cfg.backend
    first_rank = mg.offset == 0   # counts the replicated leaves' metrics once

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = tpm.loss(tree_unflatten(params, leaves), batch)[0]
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    def slice_of(i, r, sum_sq=None):
        return engine.LeafSlice(maps[i][r], numels[i], sum_sq)

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
                        leaf_slice=slice_of(i, r)).values for r in range(mg.local)])
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
        lr = step_cfg.lr(state.step)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        n_leaves = len(p_leaves)
        # msgs[i][r]: local rank r's messages of leaf i, one a local worker
        # (a replicated leaf: r = 0 only)
        msgs = [[[] for _ in range(mg.local if pl.sharded else 1)] for pl in pls]
        scales = [[[] for _ in range(mg.local if pl.sharded else 1)] for pl in pls]
        nnz = [[zero] * mg.local for _ in range(group.local)]
        losses, sources, seeds = [], [], []

        def compress_worker(j, src, shared):
            for i, g in enumerate(src):
                seed_i = prng.fold_seed_int(seeds[j], i)
                sh = shared[i] if shared is not None else None
                if pls[i].sharded:
                    sq = (collectives.tp_sum([engine.leaf_sum_sq(x) for x in g.unbind(0)], mg)
                          if need_sq else None)
                    parts = [(r, g[r], slice_of(i, r, sq)) for r in range(mg.local)]
                else:
                    parts = [(0, g, None)]
                for r, x, lsl in parts:
                    kw = {} if mode == "decoded" else {"wire": wire}
                    msg = engine.compress_leaf(x, comp, seed_i, backend=backend, shared_linf=sh,
                                               leaf_slice=lsl, **kw)
                    scales[i][r].append(msg.scale)
                    if mode == "decoded":
                        msgs[i][r].append(msg.values)
                        continue
                    values = wire.mask_message(msg.values, mask[j])
                    msgs[i][r].append(values)
                    if pls[i].sharded or first_rank:
                        nnz[j][r] = nnz[j][r] + wire.message_nnz(values)

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
            # the sampled workers (exact in any order)
            shared = []
            for i in range(n_leaves):
                per_worker = []
                for s in sources:
                    x = s[i]
                    parts = ([torch.amax(torch.abs(y.to(torch.float32))) for y in x.unbind(0)]
                             if pls[i].sharded else [torch.amax(torch.abs(x.to(torch.float32)))])
                    per_worker.append(collectives.tp_max(parts, mg) if pls[i].sharded
                                      else parts[0])
                local = torch.stack(per_worker)
                local = torch.where(mask, local, torch.zeros((), device=dev))
                with collectives.for_model_ranks(mg.ranks):
                    shared.append(group.all_reduce(torch.amax(local),
                                                   op=torch.distributed.ReduceOp.MAX))
            for j in range(group.local):
                compress_worker(j, sources[j], shared)
                sources[j] = None

        n_sel = collectives.scalar_psum(mask.to(torch.float32), group)
        ef_flat = (tree_leaves(state.ef_residual) if state.ef_residual is not None
                   else [None] * n_leaves)
        wire_bytes, gather_hbm = 0.0, 0.0
        for i, p in enumerate(p_leaves):
            n_dev = dev_numel[i]
            wire_bytes += collectives.uplink_ledger(mode, wire, n_dev, share_linf=share_linf)
            if mode != "decoded":
                gather_hbm = max(gather_hbm, wire.gather_hbm_bytes(n_dev))
            sharded = pls[i].sharded
            views = list(p.unbind(0)) if sharded else [p]
            efs = (list(ef_flat[i].unbind(0)) if sharded else [ef_flat[i]]) \
                if ef_flat[i] is not None else [None] * len(views)
            aggs = []
            for r, pr in enumerate(views):
                stack = torch.stack(msgs[i][r])
                msgs[i][r] = None
                # the census bills a slice's exchange to its rank's device, a
                # replicated leaf's to every local rank's
                with collectives.for_model_ranks((mg.offset + r,) if sharded else mg.ranks):
                    if mode == "decoded":
                        agg, k = collectives.decoded_exchange(
                            stack, torch.stack(scales[i][r]), mask, group,
                            is_ternary=comp.is_ternary)
                        if sharded or first_rank:
                            for j in range(group.local):
                                nnz[j][r] = nnz[j][r] + k[j]
                    else:
                        wire_scale = torch.stack(scales[i][r]) if mode == "pack8" else None
                        agg = wire.exchange(stack, pr.numel(), tuple(pr.shape),
                                            scale=wire_scale)
                del stack
                aggs.append(agg)
            l1 = None
            if sharded and comp.server == "scaled_sign_ef" and mode == "votes":
                # the whole leaf's L1: the slices' partials in rank order
                l1 = collectives.tp_sum([engine.ef_l1_partial(a, e, n_sel)
                                         for a, e in zip(aggs, efs)], mg)
            for r, (pr, agg, ef) in enumerate(zip(views, aggs, efs)):
                if mode != "votes":
                    mean_scale = scales[i][r][-1] if mode == "scaled_votes" else None
                    new_p, new_ef = engine.server_apply(pr, agg, comp, lr=lr, ef=ef, n_sel=n_sel,
                                                        server="mean", scale=mean_scale,
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
            del aggs

        f32 = np.float32
        total = sum(numels)
        loss_mean = collectives.scalar_psum(torch.stack(losses), group) / f32(n_workers)
        worker_nnz = torch.stack([collectives.tp_sum(nnz[j], mg) for j in range(group.local)])
        nnz_mean = (collectives.scalar_psum(worker_nnz, group) / f32(n_workers) / f32(total))
        metrics = {"loss": loss_mean, "lr": torch.tensor(lr, device=dev), "nnz_frac": nnz_mean,
                   "participated": n_sel,
                   "wire_bytes_per_device": torch.tensor(f32(wire_bytes), device=dev),
                   "gather_hbm_bytes": torch.tensor(f32(gather_hbm), device=dev)}
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
    step.plan = None
    step.placements = placements
    step.tp_model = tpm
    step.shard_state = shard_state
    step.whole_state = whole_state
    step.checkpoint_state = checkpoint_state
    step.state_shardings = state_shardings
    return step

