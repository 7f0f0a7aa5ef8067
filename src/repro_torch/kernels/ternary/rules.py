"""Ternarization rules, the port's copy of ``repro.kernels.ternary.rules``.

A rule maps a float32 tensor to ternary {-1, 0, +1} symbols::

    rule(g, u, param) -> float32 in {-1.0, 0.0, +1.0}

(NaN and -0.0 may come out where ``jnp.sign`` passes them through; the cast
to int8 in ``ref.py`` maps both to 0). ``u(salt)`` returns the
coordinate-indexed uniform[0,1) stream with the caller's seed folded by
``salt`` (0 = the unfolded seed). ``param`` is float32, broadcastable against
g: sparsign's budget B, noisy_sign's sigma, stochastic_ternary's normalizer.
Every operation keeps the JAX rule's float32 order, so the CUDA kernel
(``csrc/ternary.cu``) and this plain version can be held bit for bit.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import jnp_sign

#: float32 constants as XLA rounds them: ``2.0 * jnp.pi`` is a Python float
#: that meets a float32 array once, and ``jnp.float32(1e-12)`` is the guard
TWO_PI_F32 = 2.0 * math.pi
EPS_F32 = 1e-12


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _zero(g: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=g.dtype, device=g.device)


def sparsign_rule(g: torch.Tensor, u, param: torch.Tensor) -> torch.Tensor:
    """Def. 1: sign(g_i) w.p. min(|g_i| * B, 1) else 0; param = B."""
    p = torch.clamp(torch.abs(g) * param, 0.0, 1.0)
    return torch.where(u(0) < p, jnp_sign(g), _zero(g))


def sign_rule(g: torch.Tensor, u, param: torch.Tensor) -> torch.Tensor:
    """signSGD (Bernstein et al. 2018): deterministic sign; sign(0) = 0.
    param unused; no uniforms drawn."""
    return jnp_sign(g)


def noisy_sign_rule(g: torch.Tensor, u, param: torch.Tensor) -> torch.Tensor:
    """Noisy signSGD (Chen et al. 2020a): sign(g + sigma * n), n ~ N(0, 1) by
    Box-Muller from the streams folded by 1 and 2; param = sigma."""
    u1 = torch.maximum(u(1), _f32(EPS_F32, g))  # guard u1 = 0 for the log
    u2 = u(2)
    n = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_f32(TWO_PI_F32, g) * u2)
    return jnp_sign(g + param * n)


def stochastic_ternary_rule(g: torch.Tensor, u, param: torch.Tensor) -> torch.Tensor:
    """TernGrad / 1-bit QSGD: sign(g_i) w.p. |g_i| / s else 0; param = s (a
    local norm, or TernGrad's magnitude-shared max)."""
    p = torch.clamp(torch.abs(g) / torch.maximum(param, _f32(EPS_F32, g)), 0.0, 1.0)
    return torch.where(u(0) < p, jnp_sign(g), _zero(g))


#: rule name -> rule fn; the CUDA kernel's rule ids follow this order
RULES = {
    "sparsign": sparsign_rule,
    "sign": sign_rule,
    "noisy_sign": noisy_sign_rule,
    "stochastic_ternary": stochastic_ternary_rule,
}
