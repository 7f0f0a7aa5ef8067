"""Server-side error feedback (Alg. 2, Eq. 8), the port of
``repro.core.error_feedback``:

    g_tilde = C(mean_delta + e)
    e'      = mean_delta + e - g_tilde

The residual lives on the server only; workers stay stateless. The per-leaf
tree helpers of the JAX package wait for the multi-tensor trainers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.aggregation import scaled_sign_server


@dataclasses.dataclass
class EFState:
    residual: torch.Tensor  # float32, shaped like the update


def init_ef(shape_like: torch.Tensor) -> EFState:
    return EFState(residual=torch.zeros(shape_like.shape, dtype=torch.float32,
                                        device=shape_like.device))


def ef_server_step(
    state: EFState,
    mean_delta: torch.Tensor,
    server_compressor: Callable[[torch.Tensor], torch.Tensor] = scaled_sign_server,
) -> tuple[torch.Tensor, EFState]:
    """One server round: returns (g_tilde, new_state)."""
    acc = mean_delta.to(torch.float32) + state.residual
    g_tilde = server_compressor(acc)
    return g_tilde, EFState(residual=acc - g_tilde)
