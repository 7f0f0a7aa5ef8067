"""Launch wrapper of the hand-written EF-server kernel (``csrc/ef_server.cu``),
which replaces ``repro/kernels/ef_server/kernel.py:ef_server_2d``."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_cuda_tensor


def ef_server_cuda(delta_mean: torch.Tensor, residual: torch.Tensor,
                   scale: torch.Tensor):
    """(scale * sign(d + e), (d + e) - that) on the card, both float32.
    ``scale`` is a one-element float32 CUDA tensor, read by the kernel."""
    check_cuda_tensor("delta_mean", delta_mean, (torch.float32,))
    check_cuda_tensor("residual", residual, (torch.float32,))
    check_cuda_tensor("scale", scale, (torch.float32,))
    if residual.shape != delta_mean.shape:
        raise ValueError(f"residual {tuple(residual.shape)} and delta "
                         f"{tuple(delta_mean.shape)} differ in shape")
    if scale.numel() != 1:
        raise ValueError(f"scale must hold one value, got {scale.numel()}")
    out = torch.empty_like(delta_mean)
    new_e = torch.empty_like(delta_mean)
    err = build.library("ef_server")(
        delta_mean.data_ptr(), residual.data_ptr(), scale.data_ptr(), out.data_ptr(),
        new_e.data_ptr(), delta_mean.numel(),
        torch.cuda.current_stream(delta_mean.device).cuda_stream)
    build.check_launch("ef_server", err)
    ef_server_cuda.launches += 1
    return out, new_e


ef_server_cuda.launches = 0
