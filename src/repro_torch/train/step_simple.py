"""`simple`-mode data-parallel train step, the port of
``repro.train.step_simple``.

The paper's M workers are a ``WorkerGroup`` (``launch.mesh``): a leading
worker dimension in this process, over the processes of a
``torch.distributed`` group when there is one. Parameters are replicated, so
one update serves every worker of the process. Per round (Algorithm 1, or
Algorithm 2 with tau > 1 local steps):

  1. every worker computes the local gradient of its microbatch (the global
     batch split on axis 0, or axis 1 when tau > 1, in worker order);
  2. it compresses every gradient leaf with its own counter stream, in the
     wire's native format (int8 votes on the psum wires; on
     ``allgather_packed`` the 2-bit packed view, for a golomb-format row the
     Golomb/Rice coded stream, or for the pack8 row, qsgd8, the int8 level
     view and its decode scale, each from one fused kernel); seeds as in JAX:
     ``wseed = fold(rseed, 0x5EED) + widx * 0x9E3779B9``, leaf i drawing from
     ``fold(wseed, i)`` with counter base 0, leaves in JAX's flatten order;
  3. one wire exchange per leaf gives the vote total, or on the pack8 wire
     the dequantized sum (or the weighted sum and the realized participation
     W under elastic participation);
  4. ``engine.server_apply`` steps the parameters once: C(.) and SGD.

The workers run one after another, each holding one set of gradients, and
their messages are kept until the exchange; a compressor that shares the
workers' L-inf norm (TernGrad, ``linf_share``) keeps every worker's
gradients until the shared max is known.

``bucketed=True`` is JAX's bucketed uplink: a ``bucketing.BucketPlan`` built
with the step lays the leaves' messages out in buckets (one for the whole
tree unless ``bucket_bytes`` caps them), each worker writes each message
straight into its slot of a (local, rows, width) bucket buffer, and ONE
exchange a bucket replaces the per-leaf ones; the shared L-inf max is one
vector for all leaves. Each slot is the per-leaf message byte for byte, so
the parameters equal the per-leaf step's. ``ring_chunk_rows`` makes a gather
wire the chunked ring (``collectives``); per leaf, the ring steps through the
workers' messages without stacking them.

On the golomb wire the step's nnz reads the messages' headers (the shipped
nonzeros), and ``nnz_dropped`` counts the nonzeros all workers' messages
truncated at capacity this step (0 unless the realized density outran the
plan fraction ``golomb_p``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import engine, prng
from repro_torch.core.algorithm import CompressionConfig, worker_stream_seed
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.dist import bucketing, collectives
from repro_torch.dist.collectives import ParticipationSpec, WorkerGroup
from repro_torch.train import sampling
from repro_torch.train.state import LrSchedule, TrainState

LOCAL_LEAF_SALT = 7000   # the tau local steps' per-leaf streams: fold(wseed, 7000 + i)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    compression: CompressionConfig
    lr: LrSchedule
    local_lr: float = 1.0          # eta_L (Alg. 2)
    vote_impl: str = "psum"        # psum | hier | allgather_packed
    quorum: Any = 1                # int, or a tree prefix of the params with per-leaf ints
    backend: Optional[str] = None  # None: the kernels for CUDA tensors, plain for CPU
    bucketed: bool = False         # one exchange a wire bucket instead of one a leaf
    bucket_bytes: Optional[int] = None      # payload cap a bucket (None: one bucket)
    ring_chunk_rows: Optional[int] = None   # ring gather: payload rows a chunk (gather
                                            # wires only; None: monolithic gather)
    participation: Optional[ParticipationSpec] = None
    golomb_p: Optional[float] = None   # plan-time nnz fraction sizing the golomb
                                       # wire's capacity (None: the target of a
                                       # target_sparsity budget)


def worker_batch(batch: dict, widx: int, n_workers: int, batch_axis: int, device) -> dict:
    """Worker ``widx``'s microbatch: its contiguous share of ``batch_axis``
    (JAX's batch sharding over the worker axes, in flat worker order)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.shape[batch_axis] % n_workers:
            raise ValueError(f"batch leaf {k!r} has {t.shape[batch_axis]} rows on axis "
                             f"{batch_axis}, not a multiple of the {n_workers} workers")
        size = t.shape[batch_axis] // n_workers
        out[k] = t.narrow(batch_axis, widx * size, size).to(device)
    return out


def _grads(model, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = model.loss(tree_unflatten(params, leaves), batch)[0]
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def _local_grads(model, params, batch, comp: CompressionConfig, wseed: int,
                 local_lr: float, backend=None):
    """Returns (loss, message-source leaves).

    tau == 1: the raw local gradient (Alg. 1).
    tau > 1 : the int32 sum of the tau compressed local steps, as float32
              (Alg. 2); batch leaves carry a leading tau axis."""
    tau = comp.local_steps
    if tau == 1:
        return _grads(model, params, batch)
    local_cfg = engine.local_step_config(comp)
    w = tree_leaves(params)
    acc = [torch.zeros(p.shape, dtype=torch.int32, device=p.device) for p in w]
    losses = []
    for c in range(tau):
        micro = {k: v[c] for k, v in batch.items()}
        loss, grads = _grads(model, tree_unflatten(params, w), micro)
        losses.append(loss)
        for i, g in enumerate(grads):
            q = engine.compress_leaf(g, local_cfg, prng.fold_seed_int(wseed, LOCAL_LEAF_SALT + i),
                                     counter_base=(c * g.numel()) & prng.MASK32,
                                     backend=backend).values
            eta = torch.full((), float(local_lr), dtype=w[i].dtype, device=w[i].device)
            w[i] = w[i] - eta * q.to(w[i].dtype)
            acc[i] += q.to(torch.int32)
    return torch.mean(torch.stack(losses)), [a.to(torch.float32) for a in acc]


def build_train_step(model, step_cfg: TrainStepConfig, group: WorkerGroup) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics). ``batch`` holds
    the global batch (numpy arrays or tensors); the step moves each worker's
    share to the parameters' device. Metrics are 0-d float32 tensors. The
    worker axes are the group's.

    Like JAX's donated buffers, the step writes each new leaf of the
    parameters and the EF residual into the input state's tensor, leaf by
    leaf, so one copy of each is alive instead of two; the input state must
    not be read again. A group with a 'model' axis of size T > 1 takes the
    tensor-parallel step (``train.step_tp``), its state in the TP layout."""
    if group.model_size > 1:
        from repro_torch.train.step_tp import build_tp_train_step  # it imports this module
        return build_tp_train_step(model, step_cfg, group)
    comp = step_cfg.compression
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
    quorum_leaves = tree_leaves(engine.broadcast_quorum(step_cfg.quorum, model.param_shapes()))
    q_fracs = ([part.resolve_q_frac(q, wire.n_workers) for q in quorum_leaves]
               if part is not None else None)
    if mode != "votes" and any(q != 1 for q in quorum_leaves):
        raise ValueError(
            f"quorum={step_cfg.quorum!r} is a vote-server deadband, but compressor "
            f"{comp.compressor!r} with server {comp.server!r} rides the {mode!r} wire where "
            f"it would be ignored; use a vote server ({engine.VOTE_SERVERS}) or quorum=1")
    plan = None
    if step_cfg.bucketed:
        fmt = bucketing.wire_bucket_format(mode, wire)
        # golomb slots are capacity rows, a function of (n, p) the wire owns
        plan = bucketing.build_bucket_plan(
            tree_leaves(model.param_shapes()), fmt, bucket_bytes=step_cfg.bucket_bytes,
            rows_fn=(wire.payload_rows if fmt == "golomb" else None))
        # leaf i's (bucket, slot): the plan is in leaf order
        slot_of = {s.index: (bi, s) for bi, b in enumerate(plan.buckets) for s in b.slots}
    # the per-leaf ring takes the workers' messages as they are, unstacked
    ring = mode != "decoded" and getattr(wire, "ring_chunk_rows", None) is not None
    n_workers = group.n_workers
    batch_axis = 1 if comp.local_steps > 1 else 0
    backend = step_cfg.backend

    def step(state: TrainState, batch: dict):
        params = state.params
        p_leaves = tree_leaves(params)
        dev = p_leaves[0].device
        widx = collectives.worker_index(group, dev)
        rseed = sampling.round_seed(state.seed, state.step)
        mask = sampling.participation_mask(rseed, state.step, widx,
                                           comp.worker_sample_fraction)
        w_eff = None
        if part is not None:
            # the round's reporting set: the sampled workers whose reports
            # arrive; w_eff (static weight x report bit) rides the wire
            mask = mask & sampling.report_mask(rseed, state.step, widx, part.dropout)
            w_eff = part.weights_array(n_workers, dev)[widx] * mask.to(torch.float32)
        lr = step_cfg.lr(state.step)
        zero = torch.zeros((), dtype=torch.float32, device=dev)

        # -- the workers: local gradients, then wire-native messages --------
        # (per leaf, decoded mode keeps each worker's values and decode scale:
        # the exchange decodes them and counts their nnz; bucketed, each
        # message goes straight into its slot of the bucket buffers)
        n_leaves = len(p_leaves)
        msgs = [[] for _ in range(n_leaves)]
        scales = [[] for _ in range(n_leaves)]
        bufs = ([torch.zeros((group.local, b.rows, bucketing.ROW_WIDTH[plan.fmt]),
                             dtype=bucketing.ROW_DTYPE[plan.fmt], device=dev)
                 for b in plan.buckets] if plan is not None else None)
        nnz = [zero] * group.local
        dropped = [zero] * group.local
        losses, sources, seeds = [], [], []

        def compress_worker(j, src, shared):
            for i, g in enumerate(src):
                seed_i = prng.fold_seed_int(seeds[j], i)
                sh = shared[i] if shared is not None else None
                slot = slot_of[i] if plan is not None else None
                if mode == "decoded":
                    msg = engine.compress_leaf(g, comp, seed_i, backend=backend,
                                               shared_linf=sh)
                    # elastic: the weight premultiplies the decode scale
                    sc = msg.scale * w_eff[j] if part is not None else msg.scale
                    if slot is None:
                        msgs[i].append(msg.values)
                        scales[i].append(sc)
                        continue
                    values, k = collectives.decoded_message(msg.values, sc, mask[j],
                                                            is_ternary=comp.is_ternary)
                    nnz[j] = nnz[j] + k
                    values = bucketing.as_rows(values, plan.fmt, slot[1].rows)
                else:
                    if slot is None:
                        msg = engine.compress_leaf(g, comp, seed_i, backend=backend, wire=wire,
                                                   shared_linf=sh)
                    else:
                        msg = engine.compress_leaf_rows(g, comp, seed_i, rows=slot[1].rows,
                                                        backend=backend, wire=wire,
                                                        shared_linf=sh)
                    values = wire.mask_message(msg.values, mask[j])
                    scales[i].append(msg.scale)
                    nnz[j] = nnz[j] + wire.message_nnz(values)
                    if count_dropped:
                        dropped[j] = dropped[j] + wire.message_dropped(values)
                    if slot is None:
                        msgs[i].append(values)
                        continue
                bi, s = slot
                bufs[bi][j, s.row_start:s.row_start + s.rows] = values
                del values   # the slot holds it now

        for j in range(group.local):
            w = group.rank * group.local + j
            seeds.append(worker_stream_seed(rseed, w))
            micro = worker_batch(batch, w, n_workers, batch_axis, dev)
            loss, src = _local_grads(model, params, micro, comp, seeds[j],
                                     step_cfg.local_lr, backend=backend)
            losses.append(loss)
            if share_linf:
                sources.append(src)    # held until the shared max is known
            else:
                compress_worker(j, src, None)
            del src
        if share_linf:
            # TernGrad's magnitude sharing / linf_share budgets: one max over
            # the sampled workers per leaf (bucketed: one vector for all
            # leaves) before compressing
            if plan is not None:
                shared = collectives.worker_shared_linf_many(sources, group, mask=mask)
            else:
                shared = [collectives.worker_shared_linf([s[i] for s in sources], group,
                                                         mask=mask)
                          for i in range(n_leaves)]
            for j in range(group.local):
                compress_worker(j, sources[j], shared)
                sources[j] = None

        # -- the exchange and the server -----------------------------------
        n_sel = collectives.scalar_psum(mask.to(torch.float32), group)
        ef_flat = (tree_leaves(state.ef_residual) if state.ef_residual is not None
                   else [None] * n_leaves)
        new_leaves, ef_leaves = list(p_leaves), list(ef_flat)
        if mode == "decoded":   # the mean's divisor: W (one protocol scalar) or n_sel
            n_dec = collectives.scalar_psum(w_eff, group) if part is not None else n_sel

        def apply(i, agg, n_or_w):
            """C(.) and SGD on leaf i from its exchanged sum, written in place."""
            p, ef = p_leaves[i], ef_flat[i]
            if mode != "votes":
                # pack8 and decoded sums arrive dequantized; scaled_votes
                # carries ONE shared scale
                mean_scale = scales[i][-1] if mode == "scaled_votes" else None
                new_p, new_ef = engine.server_apply(p, agg, comp, lr=lr, ef=ef, n_sel=n_or_w,
                                                    server="mean", scale=mean_scale,
                                                    backend=backend)
            elif part is not None:
                new_p, new_ef = engine.server_apply(p, agg, comp, lr=lr, ef=ef,
                                                    part_total=n_or_w, q_frac=q_fracs[i],
                                                    backend=backend)
            else:
                new_p, new_ef = engine.server_apply(p, agg, comp, lr=lr, ef=ef, n_sel=n_sel,
                                                    quorum=quorum_leaves[i], backend=backend)
            p.copy_(new_p)
            if ef is not None and new_ef is not ef:
                ef.copy_(new_ef)

        total = sum(p.numel() for p in p_leaves)
        if plan is not None:
            for bi, b in enumerate(plan.buckets):
                buf, bufs[bi] = bufs[bi], None
                bscale = None
                if mode == "pack8":   # (local, n_slots): each worker's slot scales
                    bscale = torch.stack([torch.stack([scales[s.index][j] for s in b.slots])
                                          for j in range(group.local)])
                if mode == "decoded":
                    parts = bucketing.split_bucket(
                        collectives.decoded_exchange_bucket(buf, group), b)
                    wtots = n_dec
                elif part is not None:
                    # W is per slot (per coordinate) on the psum wires, one
                    # scalar on the gather wires
                    parts, wtots = wire.exchange_bucket_weighted(buf, b, weight=w_eff,
                                                                 scale=bscale)
                else:
                    parts, wtots = wire.exchange_bucket(buf, b, scale=bscale), n_sel
                del buf
                for k, (s, agg) in enumerate(zip(b.slots, parts)):
                    apply(s.index, agg, wtots[k] if isinstance(wtots, list) else wtots)
                del parts
            pay, scal = bucketing.plan_ledger(mode, wire, plan, share_linf=share_linf)
            wire_bytes = pay + scal
            gather_hbm = bucketing.plan_gather_hbm_bytes(mode, wire, plan)
        else:
            wire_bytes, gather_hbm = 0.0, 0.0
            for i, p in enumerate(p_leaves):
                n, shape = p.numel(), tuple(p.shape)
                wire_bytes += collectives.uplink_ledger(mode, wire, n, share_linf=share_linf)
                if mode != "decoded":
                    gather_hbm = max(gather_hbm, wire.gather_hbm_bytes(n))
                stack = msgs[i] if ring else torch.stack(msgs[i])
                msgs[i] = None
                if mode == "decoded":
                    agg, k = collectives.decoded_exchange(stack, torch.stack(scales[i]), mask,
                                                          group, is_ternary=comp.is_ternary)
                    nnz = [a + b for a, b in zip(nnz, k)]
                    n_or_w = n_dec
                else:
                    # pack8 gathers every worker's decode scale
                    wire_scale = torch.stack(scales[i]) if mode == "pack8" else None
                    if part is not None:
                        agg, n_or_w = wire.exchange_weighted(stack, n, shape, weight=w_eff,
                                                             scale=wire_scale)
                    else:
                        agg, n_or_w = wire.exchange(stack, n, shape, scale=wire_scale), n_sel
                del stack
                apply(i, agg, n_or_w)
                del agg

        f32 = np.float32
        loss_mean = collectives.scalar_psum(torch.stack(losses), group) / f32(n_workers)
        nnz_mean = (collectives.scalar_psum(torch.stack(nnz), group) / f32(n_workers)
                    / f32(total))
        metrics = {"loss": loss_mean, "lr": torch.tensor(lr, device=dev), "nnz_frac": nnz_mean,
                   "participated": n_sel,
                   "wire_bytes_per_device": torch.tensor(f32(wire_bytes), device=dev),
                   "gather_hbm_bytes": torch.tensor(f32(gather_hbm), device=dev)}
        if count_dropped:
            metrics["nnz_dropped"] = collectives.scalar_psum(torch.stack(dropped), group)
        new_state = TrainState(
            params=tree_unflatten(params, new_leaves),
            ef_residual=(tree_unflatten(params, ef_leaves)
                         if state.ef_residual is not None else None),
            step=state.step + 1, seed=state.seed)
        return new_state, metrics

    step.wire = wire
    step.mode = mode
    step.plan = plan
    return step
