"""Shared model plumbing, the port of ``repro.models.common``: the RMS norm,
the SwiGLU and GELU activations and the initializer. The GSPMD sharding hints
(``hint``, ``axis_rules``) have no counterpart on one card and are left out."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) * (1 + scale), computed in float32 and cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.to(torch.float32))).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# a leaf above this many coordinates is drawn one slice of its leading axis
# at a time: drawn whole, its float32 draw alone would be 4 bytes a coordinate
# (36 GB for qwen2.5-32b's stacked FFN leaves) on top of the weights
SLICED_DRAW_COORDS = 2 ** 31


def _draw(generator: torch.Generator, shape, std: float, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
    return t.mul_(std)


def dense_init(generator: torch.Generator, shape, dtype: torch.dtype, device,
               scale: float | None = None) -> torch.Tensor:
    """Truncated normal in [-2, 2] standard deviations, std ``fan_in ** -0.5``
    with fan_in = shape[0], as the JAX initializer draws it (the numbers
    differ: torch's generator is not ``jax.random``). A leaf of more than
    ``SLICED_DRAW_COORDS`` coordinates is drawn one slice of its leading
    axis after the other into the output, so the float32 draw of one slice
    is all that is alive beside it."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
    std = scale if scale is not None else fan_in ** -0.5
    if math.prod(shape) <= SLICED_DRAW_COORDS:
        return _draw(generator, shape, std, device).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i].copy_(_draw(generator, shape[1:], std, device))
    return out
