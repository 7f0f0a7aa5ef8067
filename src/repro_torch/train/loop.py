"""Training driver, the port of ``repro.train.loop``: the step loop with its
log points. Checkpoints, resume and failure injection are not ported yet and
raise when asked for."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.train.state import TrainState


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    fail_at_step: Optional[int] = None

    def __post_init__(self):
        if self.ckpt_dir is not None or self.fail_at_step is not None:
            raise NotImplementedError("checkpoints, resume and failure injection are not "
                                      "ported yet (ROADMAP.md)")


def run(train_step: Callable, state: TrainState, batch_fn: Callable[[int], dict],
        cfg: LoopConfig, *, log: Callable[[str], None] = print):
    """Runs steps ``state.step`` .. ``cfg.total_steps - 1``; returns (state,
    history). ``batch_fn`` is a pure function of the step index. At a log
    point the metrics are read to the host (which waits for the device), so
    ``wall_s`` is host seconds since the loop began, ending in that wait."""
    history = []
    t0 = time.perf_counter()
    for step_idx in range(state.step, cfg.total_steps):
        state, metrics = train_step(state, batch_fn(step_idx))
        if step_idx % cfg.log_every == 0 or step_idx == cfg.total_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step_idx
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            log(f"[loop] step {step_idx}: " +
                " ".join(f"{k}={v:.5g}" for k, v in m.items() if k != "step"))
    return state, history
