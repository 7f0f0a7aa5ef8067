"""Plain PyTorch version of the fused server EF step (Alg. 2, Eq. 8), bit for
bit ``repro.kernels.ef_server.ref`` given the same scale:

    out = s * sign(d + e)        (jnp.sign semantics: +-0.0 and NaN pass through)
    e'  = (d + e) - out

with s = ||d + e||_1 / n reduced beforehand (``ef_scale``). The L1 sum is
taken in another order than XLA's, so the scale agrees only to rounding."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import device_tensor, jnp_sign


def ef_scale(delta_mean: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    acc = delta_mean.to(torch.float32) + residual.to(torch.float32)
    return torch.sum(torch.abs(acc)) / device_tensor(float(acc.numel()), acc)


def ef_server_ref(delta_mean: torch.Tensor, residual: torch.Tensor, scale):
    acc = delta_mean.to(torch.float32) + residual.to(torch.float32)
    out = device_tensor(scale, acc) * jnp_sign(acc)
    return out, acc - out
