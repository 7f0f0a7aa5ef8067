"""Ternarization rules, the port's copy of ``repro.kernels.ternary.rules``.

A rule maps a float32 tensor to ternary {-1, 0, +1} symbols::

    rule(g, u, param) -> float32 in {-1.0, 0.0, +1.0}

where ``u(salt)`` returns the coordinate-indexed uniform[0,1) stream with the
caller's seed folded by ``salt`` (0 = the unfolded seed). This slice carries
the sparsign rule only; sign, noisy_sign and stochastic_ternary arrive with
the ternary kernel (ROADMAP queue 2, row 4).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import jnp_sign


def sparsign_rule(g: torch.Tensor, u, param: torch.Tensor) -> torch.Tensor:
    """Def. 1: sign(g_i) w.p. min(|g_i| * B, 1) else 0; param = B (float32,
    broadcastable against g)."""
    p = torch.clamp(torch.abs(g) * param, 0.0, 1.0)
    return torch.where(u(0) < p, jnp_sign(g), torch.zeros((), dtype=g.dtype, device=g.device))


#: rule name -> rule fn
RULES = {
    "sparsign": sparsign_rule,
}
