"""Public fused EF-server op: the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import device_tensor
from repro_torch.kernels.ef_server.kernel import ef_server_cuda
from repro_torch.kernels.ef_server.ref import ef_scale, ef_server_ref


def ef_server_op(delta_mean: torch.Tensor, residual: torch.Tensor, scale=None):
    """Fused Eq. 8: (g_tilde, new_residual), float32, shaped like the input.
    ``scale`` defaults to ||delta + residual||_1 / n, reduced on the device."""
    if scale is None:
        scale = ef_scale(delta_mean, residual)
    if not delta_mean.is_cuda:
        return ef_server_ref(delta_mean, residual, scale)
    s = device_tensor(scale, delta_mean).reshape(1)
    return ef_server_cuda(delta_mean.to(torch.float32).contiguous(),
                          residual.to(torch.float32).contiguous(), s.contiguous())
