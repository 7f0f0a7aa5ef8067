"""Public fused vote->update ops: the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import device_tensor
from repro_torch.kernels.vote_update.kernel import vote_update_cuda, weighted_vote_update_cuda
from repro_torch.kernels.vote_update.ref import vote_update_ref, weighted_vote_update_ref


def vote_update_op(w: torch.Tensor, votes: torch.Tensor, eta, *, quorum: int = 1) -> torch.Tensor:
    """w' = w - eta * sign(votes) with the quorum deadband; any shape, w's
    dtype kept. ``eta`` is a host scalar (a launch argument on the card)."""
    if not w.is_cuda:
        return vote_update_ref(w, votes, eta, quorum)
    if votes.dtype == torch.int16:   # the wires' sum dtype for 128 to 32767 workers
        votes = votes.to(torch.int32)
    return vote_update_cuda(w.contiguous(), votes.contiguous(), float(eta), quorum)


def weighted_vote_update_op(w: torch.Tensor, wvotes: torch.Tensor, wtot, eta, *,
                            q_frac: float) -> torch.Tensor:
    """Elastic update: w' = w - eta * sign(wvotes) with the
    participation-normalized deadband ``|wvotes| >= q_frac * wtot``; any
    shape, w's dtype kept. ``wtot`` (the realized participation) is a scalar,
    a one-element tensor or one value per coordinate; the kernel reads it from
    device memory, so a W reduced on the card costs no host wait."""
    if not w.is_cuda:
        return weighted_vote_update_ref(w, wvotes, wtot, eta, q_frac)
    t = device_tensor(wtot, w).reshape(-1)
    return weighted_vote_update_cuda(w.contiguous(), wvotes.to(torch.float32).contiguous(),
                                     t.contiguous(), float(eta), float(q_frac))
