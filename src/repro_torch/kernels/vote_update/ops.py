"""Public fused vote->update op: the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU."""

from __future__ import annotations

import torch

from repro_torch.kernels.vote_update.kernel import vote_update_cuda
from repro_torch.kernels.vote_update.ref import vote_update_ref


def vote_update_op(w: torch.Tensor, votes: torch.Tensor, eta, *, quorum: int = 1) -> torch.Tensor:
    """w' = w - eta * sign(votes) with the quorum deadband; any shape, w's
    dtype kept. ``eta`` is a host scalar (a launch argument on the card)."""
    if not w.is_cuda:
        return vote_update_ref(w, votes, eta, quorum)
    return vote_update_cuda(w.contiguous(), votes.contiguous(), float(eta), quorum)
