"""Training launcher of the port: ``python -m repro_torch.launch.train --arch <id> [...]``.

The flags keep ``repro.launch.train``'s names and meanings (``--host-data``
is the worker count M); it runs the registry's trainer for the arch
(``simple``, or ``streamed`` for qwen2-vl-72b, jamba-1.5-large-398b and
llama4-scout-17b-a16e; ``--mode`` overrides it) on the card (or, with
``--device cpu``, the plain
versions on the CPU), with the bucketed uplink (``--bucketed``: one bucket
for the whole tree, or the streamed trainer's double-buffered layer and
outer buckets; ``--bucket-bytes`` caps a bucket's payload) and the ring
gather (``--ring``, ``--ring-chunk-rows`` rows a chunk, default
``collectives.DEFAULT_RING_CHUNK_ROWS``) on request. ``--ckpt-dir`` saves a
checkpoint every ``--ckpt-every`` steps and at the end, and resumes from
the newest compatible one there; ``--fail-at K`` dies before step K
(failure injection). A run resumed with another ``--host-data`` restores
the same logical state and trains on: a checkpoint holds whole leaves (the
streamed trainer re-cuts its slices from them), and majority-vote state has
no per-worker terms. An M-RoPE model's batch carries ``positions3``, the
three position streams equal to ``positions``, as JAX's launcher builds it.
``--host-model T`` adds a
tensor-parallel 'model' axis of T ranks (every ``simple``-mode family: the
dense attention ones, the MoE ones with their experts on 'model', mamba2
with its mixer split by heads; every compressor, wire, budget and server,
elastic participation, local steps, ``--bucketed`` with or without
``--bucket-bytes``, and ``--ring``; ``train.step_tp``), and the streamed
trainer's three architectures (``train.step_streamed``: each device a
shard of its model slice of every leaf); its checkpoints hold whole
leaves, so a run resumes at another T or M. What is not ported yet raises:
a launch on the production meshes, a streamed 'model' axis whose ranks
span processes.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, trainer_mode
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.data.synthetic import LMStreamConfig, lm_batch
from repro_torch.dist import collectives
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.model import Model
from repro_torch.train import loop as loop_lib
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step
from repro_torch.train.step_streamed import StreamedStepConfig, build_streamed_train_step


def participation_of(args):
    """A ParticipationSpec when any elastic flag is given, else None."""
    if args.worker_weights is None and args.quorum_frac is None and args.dropout <= 0.0:
        return None
    weights = (tuple(float(x) for x in args.worker_weights.split(","))
               if args.worker_weights else None)
    return collectives.ParticipationSpec(weights=weights, q_frac=args.quorum_frac,
                                         dropout=args.dropout)


def build_everything(args, group=None):
    """(cfg, model, group, step, state, comp) for parsed ``args``; ``group``
    overrides the worker group the mesh flags would build."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg)
    if group is None:
        if args.mesh != "host":
            mesh = make_production_mesh(multi_pod=(args.mesh == "multipod"))
            raise NotImplementedError(
                f"a launch on the production mesh {dict(mesh.shape)} ({mesh.size} devices, one "
                f"process a device) is not ported yet; use --mesh host")
        group = make_host_mesh(args.host_data, args.host_model)
    comp = CompressionConfig(compressor=args.compressor,
                             budget=BudgetConfig(kind=args.budget_kind, value=args.budget),
                             server=args.server, local_steps=args.tau,
                             local_budget=args.local_budget,
                             worker_sample_fraction=args.participation)
    mode = args.mode or trainer_mode(args.arch)
    ring_rows = ((args.ring_chunk_rows or collectives.DEFAULT_RING_CHUNK_ROWS)
                 if args.ring else None)
    lr = LrSchedule(base=args.lr, warmup=args.warmup)
    if mode == "simple":
        step = build_train_step(model, TrainStepConfig(
            compression=comp, lr=lr, local_lr=args.local_lr, vote_impl=args.vote_impl,
            quorum=args.quorum, bucketed=args.bucketed, bucket_bytes=args.bucket_bytes,
            ring_chunk_rows=ring_rows, participation=participation_of(args)), group)
    else:
        step = build_streamed_train_step(model, StreamedStepConfig(
            compression=comp, lr=lr, vote_impl=args.vote_impl, quorum=args.quorum,
            bucketed=args.bucketed, bucket_bytes=args.bucket_bytes, ring_chunk_rows=ring_rows,
            participation=participation_of(args)), group)
    state = init_state(model.init(args.seed, device), server=comp.server, seed=args.seed)
    if mode == "streamed" or group.model_size > 1:
        state = step.shard_state(state)
    return cfg, model, group, step, state, comp


def batch_fn_for(cfg, args):
    """step -> the global batch, numpy arrays: ``lm_batch``'s tokens, or for
    an embedding-input model frames of N(0, 0.3^2) in place of the tokens,
    and for an M-RoPE model ``positions3`` [B, S, 3]; with ``--tau`` > 1
    each entry is repeated over a leading tau axis."""
    stream = LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                            global_batch=args.batch, seed=args.seed)

    def fn(step_idx: int) -> dict:
        b = lm_batch(stream, step_idx)
        if cfg.input_kind != "tokens":
            # frame embeddings, JAX's launcher's draw: cast to float32, then scaled
            rng = np.random.RandomState(step_idx)
            b["inputs"] = rng.randn(args.batch, args.seq_len, cfg.d_model).astype(np.float32) * 0.3
        if cfg.mrope:
            b["positions3"] = np.broadcast_to(b["positions"][..., None],
                                              b["positions"].shape + (3,)).copy()
        if args.tau > 1:
            b = {k: np.broadcast_to(v[None], (args.tau,) + v.shape).copy() for k, v in b.items()}
        return b

    return fn


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false", help="full config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="host", choices=["host", "pod", "multipod"])
    ap.add_argument("--host-data", type=int, default=1)
    ap.add_argument("--host-model", type=int, default=1)
    ap.add_argument("--mode", default=None, choices=[None, "simple", "streamed"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--local-lr", type=float, default=1e-2)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--compressor", default="sparsign")
    ap.add_argument("--server", default="scaled_sign_ef")
    ap.add_argument("--vote-impl", default="psum", choices=list(collectives.VOTE_IMPLS))
    ap.add_argument("--budget", type=float, default=1.0)
    ap.add_argument("--budget-kind", default="fixed",
                    choices=["fixed", "linf_share", "l2_norm", "target_sparsity"],
                    help="budget semantics; target_sparsity doubles as the golomb wire's "
                         "plan-time nonzero fraction")
    ap.add_argument("--local-budget", type=float, default=10.0)
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--quorum", type=int, default=1)
    ap.add_argument("--quorum-frac", type=float, default=None)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--worker-weights", default=None)
    ap.add_argument("--bucketed", action="store_true")
    ap.add_argument("--bucket-bytes", type=int, default=None,
                    help="payload cap a bucket (default: one bucket)")
    ap.add_argument("--ring", action="store_true")
    ap.add_argument("--ring-chunk-rows", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--history-out", default=None)
    return ap


def main(argv=None):
    """Runs the loop; returns (state, history)."""
    args = parser().parse_args(argv)
    cfg, model, group, step, state, comp = build_everything(args)
    lcfg = loop_lib.LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                               ckpt_every=args.ckpt_every, fail_at_step=args.fail_at)
    state, history = loop_lib.run(step, state, batch_fn_for(cfg, args), lcfg)
    if args.history_out:
        with open(args.history_out, "w") as f:
            json.dump(history, f, indent=1)
    print(f"done: {len(history)} log points, final loss "
          f"{history[-1]['loss'] if history else float('nan'):.4f}")
    return state, history


if __name__ == "__main__":
    main()
