"""Training state and the learning-rate schedule, the port of
``repro.train.state``. The round counter and the base seed are host ints, so
every seed the step derives from them reaches the kernels as a launch
argument, never by a read from the card."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.core.engine import needs_server_ef


@dataclasses.dataclass
class TrainState:
    params: Any               # tree of tensors (Model.param_shapes' structure)
    ef_residual: Any          # tree of float32 residuals, or None (server EF)
    step: int                 # round counter
    seed: int                 # uint32 base seed


def init_state(params, *, server: str, seed: int) -> TrainState:
    ef = None
    if needs_server_ef(server):
        ef = tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                     for p in tree_leaves(params)])
    return TrainState(params=params, ef_residual=ef, step=0, seed=int(seed) & 0xFFFFFFFF)


@dataclasses.dataclass(frozen=True)
class LrSchedule:
    base: float = 1e-3
    warmup: int = 0
    decay_steps: Optional[int] = None   # cosine horizon; None = constant
    min_ratio: float = 0.1

    def __call__(self, step: int) -> np.float32:
        """The float32 learning rate of round ``step``, every operation in
        float32 as the JAX schedule computes it on the device."""
        f = np.float32
        lr = f(self.base)
        if self.warmup > 0:
            lr = lr * np.minimum(f(1.0), f(step + 1) / f(self.warmup))
        if self.decay_steps:
            t = np.clip((f(step) - f(self.warmup)) / f(max(self.decay_steps - self.warmup, 1)),
                        f(0.0), f(1.0))
            cos = f(0.5) * (f(1.0) + np.cos(f(math.pi) * t))
            lr = lr * (f(self.min_ratio) + (f(1.0) - f(self.min_ratio)) * cos)
        return f(lr)
