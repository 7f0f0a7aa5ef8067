"""Launch wrapper of the hand-written vote_update kernel
(``csrc/vote_update.cu``), which replaces
``repro/kernels/vote_update/kernel.py:vote_update_2d``."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_cuda_tensor

_W_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_V_DTYPES = {torch.int8: 0, torch.int32: 1}


def vote_update_cuda(w: torch.Tensor, votes: torch.Tensor, eta: float,
                     quorum: int = 1) -> torch.Tensor:
    """w' = w - eta * sign(votes) where |votes| >= quorum, on the card.
    ``eta`` is rounded to float32 on the host; w keeps its dtype."""
    check_cuda_tensor("w", w, tuple(_W_DTYPES))
    check_cuda_tensor("votes", votes, tuple(_V_DTYPES))
    if votes.shape != w.shape:
        raise ValueError(f"votes {tuple(votes.shape)} and w {tuple(w.shape)} differ in shape")
    out = torch.empty_like(w)
    err = build.library("vote_update")(
        w.data_ptr(), votes.data_ptr(), out.data_ptr(), w.numel(),
        float(np.float32(eta)), int(quorum), _W_DTYPES[w.dtype], _V_DTYPES[votes.dtype],
        torch.cuda.current_stream(w.device).cuda_stream)
    build.check_launch("vote_update", err)
    vote_update_cuda.launches += 1
    return out


vote_update_cuda.launches = 0


def weighted_vote_update_cuda(w: torch.Tensor, wvotes: torch.Tensor, wtot: torch.Tensor,
                              eta: float, q_frac: float) -> torch.Tensor:
    """w' = w - eta * sign(wvotes) where |wvotes| >= q_frac * wtot, on the
    card (``csrc/weighted_vote_update.cu``, which replaces
    ``repro/kernels/vote_update/kernel.py:weighted_vote_update_2d``).
    ``wvotes`` is float32 like w's shape; ``wtot`` a float32 CUDA tensor with
    one value, read by the kernel, or one per coordinate. ``eta`` and
    ``q_frac`` are rounded to float32 on the host; w keeps its dtype."""
    check_cuda_tensor("w", w, tuple(_W_DTYPES))
    check_cuda_tensor("wvotes", wvotes, (torch.float32,))
    check_cuda_tensor("wtot", wtot, (torch.float32,))
    if wvotes.shape != w.shape:
        raise ValueError(f"wvotes {tuple(wvotes.shape)} and w {tuple(w.shape)} differ in shape")
    per_coord = wtot.numel() == w.numel() and w.numel() > 1
    if not per_coord and wtot.numel() != 1:
        raise ValueError(f"wtot needs 1 or {w.numel()} values, got {wtot.numel()}")
    out = torch.empty_like(w)
    err = build.library("weighted_vote_update")(
        w.data_ptr(), wvotes.data_ptr(), wtot.data_ptr(), out.data_ptr(), w.numel(),
        float(np.float32(eta)), float(np.float32(q_frac)), int(per_coord), _W_DTYPES[w.dtype],
        torch.cuda.current_stream(w.device).cuda_stream)
    build.check_launch("weighted_vote_update", err)
    weighted_vote_update_cuda.launches += 1
    return out


weighted_vote_update_cuda.launches = 0
