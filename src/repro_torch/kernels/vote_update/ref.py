"""Plain PyTorch version of the fused vote->update step, bit for bit
``repro.kernels.vote_update.ref.vote_update_ref``:

    w' = w - eta * sign(votes)   where |votes| >= quorum, else w - eta * 0

in float32, cast back to w's dtype. quorum = 1 is the paper's rule. The
weighted (elastic) form waits for elastic participation (ROADMAP queue 3)."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import device_tensor


def vote_update_ref(w: torch.Tensor, votes: torch.Tensor, eta, quorum: int = 1) -> torch.Tensor:
    v = votes.to(torch.int32)
    step = torch.where(torch.abs(v) >= quorum, torch.sign(v),
                       torch.zeros((), dtype=torch.int32, device=v.device)).to(torch.float32)
    eta32 = device_tensor(eta, w)
    return (w.to(torch.float32) - eta32 * step).to(w.dtype)
