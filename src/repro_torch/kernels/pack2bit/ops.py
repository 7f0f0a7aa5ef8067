"""Public decode-sum ops of the 2-bit packed vote wire: the CUDA kernel for
gathered messages on the card, the plain version on the CPU. The stand-alone
pack and unpack kernels (``pack2bit_2d``, ``unpack2bit_2d``) come with the
serving slice; the trainer's path needs neither (every packed uplink is
fused: ``sparsign_pack2bit``, ``ternary_pack2bit``), and their plain
versions are in ``ref.py``."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import from_2d
from repro_torch.kernels.pack2bit.kernel import unpack2bit_sum_cuda, unpack2bit_wsum_cuda
from repro_torch.kernels.pack2bit.ref import unpack2bit_sum_ref, unpack2bit_wsum_ref


def unpack2bit_sum_op(gathered: torch.Tensor, n: int, shape) -> torch.Tensor:
    """(M, rows, 128) gathered packed votes -> int32 vote sum in ``shape``."""
    total = (unpack2bit_sum_cuda(gathered.contiguous()) if gathered.is_cuda
             else unpack2bit_sum_ref(gathered))
    return from_2d(total, n, shape)


def unpack2bit_wsum_op(gathered: torch.Tensor, weights: torch.Tensor, n: int,
                       shape) -> torch.Tensor:
    """(M, rows, 128) gathered packed votes + (M,) float32 weights -> float32
    ``sum_m weights[m] * votes_m`` in ``shape``."""
    if gathered.is_cuda:
        total = unpack2bit_wsum_cuda(gathered.contiguous(),
                                     weights.to(torch.float32).contiguous())
    else:
        total = unpack2bit_wsum_ref(gathered, weights)
    return from_2d(total, n, shape)
