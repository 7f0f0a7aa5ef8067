"""Training driver, the port of ``repro.train.loop``: the step loop with its
log points, checkpoints, restart and failure injection.

Fault model:
  * a straggler or a transient worker failure: worker sampling already
    leaves it out of the round (the algorithm's level, Cor. 1);
  * a process lost: resume from the newest atomic checkpoint; the data
    stream is a pure function of (seed, step) and every seed a step draws
    from comes from (state.seed, state.step), so the restarted run replays
    the same rounds bit for bit;
  * an elastic rescale: the checkpoint holds the logical state, which has no
    per-worker terms under majority vote, so a run resumes at another worker
    count M.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.state import TrainState


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    fail_at_step: Optional[int] = None   # failure injection (tests)


def _resume(state: TrainState, cfg: LoopConfig, log, shardings=None) -> TrainState:
    """The newest checkpoint of ``cfg.ckpt_dir`` that fits ``state``: a stale
    one from another model or config neither stops the run nor shadows this
    run's own checkpoints at lower steps. ``shardings``: a streamed state's
    layout (``checkpoint.restore``'s)."""
    steps = ckpt_lib.latest_steps(cfg.ckpt_dir)
    for s in reversed(steps):
        try:
            t0 = time.perf_counter()
            state, manifest = ckpt_lib.restore(cfg.ckpt_dir, state, step=s,
                                               shardings=shardings)
            log(f"[loop] resumed from step {int(manifest['step'])} "
                f"({time.perf_counter() - t0:.3f} s)")
            return state
        except ckpt_lib.CheckpointMismatchError as e:
            log(f"[loop] WARNING: skipping checkpoint step_{s:08d} in "
                f"{cfg.ckpt_dir} — written by a different model/config. {e}")
    if steps:
        log(f"[loop] WARNING: no compatible checkpoint in "
            f"{cfg.ckpt_dir}; starting fresh (delete the stale "
            f"checkpoints to reclaim their rotation slots)")
    return state


def _save(cfg: LoopConfig, step: int, state: TrainState, log, prepare=None) -> None:
    """Save ``state``; ``prepare`` (a streamed step's ``checkpoint_state``)
    gathers a state of slices into whole leaves and says whether this
    process writes them."""
    t0 = time.perf_counter()
    write = True
    if prepare is not None:
        state, write = prepare(state)
    if write:
        ckpt_lib.save(cfg.ckpt_dir, step, state, keep=cfg.keep)
        log(f"[loop] saved step {step} ({time.perf_counter() - t0:.3f} s)")


def run(train_step: Callable, state: TrainState, batch_fn: Callable[[int], dict],
        cfg: LoopConfig, *, log: Callable[[str], None] = print):
    """Runs steps ``state.step`` .. ``cfg.total_steps - 1``, resuming from
    ``cfg.ckpt_dir`` when it holds a compatible checkpoint; returns (state,
    history). ``batch_fn`` is a pure function of the step index, which is
    what makes a restart replay exactly. At a log point the metrics are read
    to the host (which waits for the device), so ``wall_s`` is host seconds
    since the loop began, ending in that wait. A checkpoint is saved every
    ``ckpt_every`` steps and at the end; ``fail_at_step`` raises
    ``RuntimeError`` before that step runs. Where the last step's periodic
    save already wrote the end (JAX's loop writes it twice), the end is not
    saved again. A streamed step (``train.step_streamed``) restores onto its
    layout and saves its state gathered whole, from rank 0."""
    shardings_of = getattr(train_step, "state_shardings", None)
    prepare = getattr(train_step, "checkpoint_state", None)
    if cfg.ckpt_dir:
        state = _resume(state, cfg, log, shardings_of(state) if shardings_of else None)
    history, saved = [], False
    t0 = time.perf_counter()
    for step_idx in range(state.step, cfg.total_steps):
        if cfg.fail_at_step is not None and step_idx == cfg.fail_at_step:
            raise RuntimeError(f"injected failure at step {step_idx}")
        state, metrics = train_step(state, batch_fn(step_idx))
        if step_idx % cfg.log_every == 0 or step_idx == cfg.total_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step_idx
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            log(f"[loop] step {step_idx}: " +
                " ".join(f"{k}={v:.5g}" for k, v in m.items() if k != "step"))
        saved = bool(cfg.ckpt_dir and cfg.ckpt_every and (step_idx + 1) % cfg.ckpt_every == 0)
        if saved:
            _save(cfg, step_idx + 1, state, log, prepare)
    if cfg.ckpt_dir and not (saved and state.step == cfg.total_steps):
        _save(cfg, cfg.total_steps, state, log, prepare)
    return state, history


def batches_from_fn(batch_fn: Callable[[int], dict], start_step: int = 0) -> Iterator:
    """A pure (step -> batch) function as an iterator that replays the same
    batches after a restart (the iterator keeps its own cursor)."""
    step = start_step
    while True:
        yield batch_fn(step)
        step += 1
