"""Plain PyTorch version of the fused vote->update step, bit for bit
``repro.kernels.vote_update.ref.vote_update_ref``:

    w' = w - eta * sign(votes)   where |votes| >= quorum, else w - eta * 0

in float32, cast back to w's dtype. quorum = 1 is the paper's rule. The
weighted (elastic) form is ``weighted_vote_update_ref``."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import device_tensor, jnp_sign


def vote_update_ref(w: torch.Tensor, votes: torch.Tensor, eta, quorum: int = 1) -> torch.Tensor:
    v = votes.to(torch.int32)
    step = torch.where(torch.abs(v) >= quorum, torch.sign(v),
                       torch.zeros((), dtype=torch.int32, device=v.device)).to(torch.float32)
    eta32 = device_tensor(eta, w)
    return (w.to(torch.float32) - eta32 * step).to(w.dtype)


def weighted_vote_update_ref(w: torch.Tensor, wvotes: torch.Tensor, wtot, eta,
                             q_frac: float) -> torch.Tensor:
    """Elastic-participation step, bit for bit
    ``repro.kernels.vote_update.ref.weighted_vote_update_ref``: w' = w - eta *
    sign(v) where ``|v| >= q_frac * W``, with v the weighted vote and W the
    realized participation (a scalar or one value per coordinate). sign is
    ``jnp.sign`` (``jnp_sign``). With uniform weights and full participation
    (W = M, q_frac = quorum / M) this is ``vote_update_ref`` bit for bit when
    M is a power of two: float32 sums of ternary votes are exact integers and
    the threshold product recovers the integer quorum exactly."""
    v = wvotes.to(torch.float32)
    thr = device_tensor(float(q_frac), w) * device_tensor(wtot, w)
    step = torch.where(torch.abs(v) >= thr, jnp_sign(v),
                       torch.zeros((), dtype=torch.float32, device=v.device))
    return (w.to(torch.float32) - device_tensor(eta, w) * step).to(w.dtype)
