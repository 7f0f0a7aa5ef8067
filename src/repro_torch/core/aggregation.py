"""Server-side aggregation rules C(.) and the majority vote, the port of
``repro.core.aggregation``. Signs follow ``jnp.sign`` (``jnp_sign``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import device_tensor, jnp_sign


def majority_vote(vote_sum: torch.Tensor) -> torch.Tensor:
    """C(.) = sign(.) over the summed ternary votes; ties stay 0. int8 out."""
    return jnp_sign(vote_sum).to(torch.int8)


def scaled_sign_server(x: torch.Tensor) -> torch.Tensor:
    """alpha-approximate C(x) = (||x||_1 / d) * sign(x) (Karimireddy et al. 2019)."""
    xf = x.to(torch.float32)
    scale = torch.sum(torch.abs(xf)) / device_tensor(float(x.numel()), xf)
    return scale * jnp_sign(xf)


def alpha_of_scaled_sign(x: torch.Tensor) -> torch.Tensor:
    """The compression quality alpha = ||x||_1^2 / (d ||x||_2^2) of scaled sign."""
    xf = x.to(torch.float32).reshape(-1)
    l1 = torch.sum(torch.abs(xf))
    l2sq = torch.clamp(torch.sum(xf * xf), min=1e-30)
    return (l1 * l1) / (x.numel() * l2sq)


def mean_server(x: torch.Tensor) -> torch.Tensor:
    """Uncompressed server aggregation (FedAvg-style mean passthrough)."""
    return x.to(torch.float32)


SERVER_AGGREGATORS = {
    "majority_vote": majority_vote,
    "scaled_sign": scaled_sign_server,
    "mean": mean_server,
}
