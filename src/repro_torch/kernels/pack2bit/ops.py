"""Public ops of the 2-bit packed vote wire over arbitrary-shape ternary
tensors: the CUDA kernels for a tensor on the card, the plain versions for a
tensor on the CPU. ``pack2bit_op``/``unpack2bit_op`` are the serving
replica's downlink (``serve/decode.py``); the trainer's uplink packs in its
fused compress kernels and decodes with the decode-sums."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import from_2d, to_2d
from repro_torch.kernels.pack2bit.kernel import (pack2bit_cuda, unpack2bit_cuda,
                                                 unpack2bit_sum_cuda, unpack2bit_wsum_cuda)
from repro_torch.kernels.pack2bit.ref import (pack2bit_ref, unpack2bit_ref, unpack2bit_sum_ref,
                                              unpack2bit_wsum_ref)


def pack2bit_op(t: torch.Tensor) -> torch.Tensor:
    """int8 ternary (any shape) -> the (rows, 128) uint8 packing of its
    canonical 2D view; ``unpack2bit_op(packed, t.numel(), t.shape)`` inverts
    it. The canonical view is part of the wire format."""
    if t.is_cuda:
        return pack2bit_cuda(t.contiguous())
    view, _ = to_2d(t.reshape(-1))
    return pack2bit_ref(view)


def unpack2bit_op(packed: torch.Tensor, n: int, shape) -> torch.Tensor:
    """(rows, 128) packed view -> int8 ternary of ``shape`` (its first n
    coordinates)."""
    t2d = unpack2bit_cuda(packed.contiguous()) if packed.is_cuda else unpack2bit_ref(packed)
    return from_2d(t2d, n, shape)


def unpack2bit_sum_op(gathered: torch.Tensor, n: int, shape, *, out=None,
                      accumulate: bool = False) -> torch.Tensor:
    """(M, rows, 128) gathered packed votes -> the vote sum in ``shape``:
    int32, or written into ``out`` (rows x 512 int8, int16 or int32) in its
    dtype, or with ``accumulate`` added into it."""
    total = (unpack2bit_sum_cuda(gathered.contiguous(), out=out, accumulate=accumulate)
             if gathered.is_cuda else
             unpack2bit_sum_ref(gathered, out=out, accumulate=accumulate))
    return from_2d(total, n, shape)


def unpack2bit_wsum_op(gathered: torch.Tensor, weights: torch.Tensor, n: int, shape, *,
                       out=None, accumulate: bool = False) -> torch.Tensor:
    """(M, rows, 128) gathered packed votes + (M,) float32 weights -> float32
    ``sum_m weights[m] * votes_m`` in ``shape``; ``out`` and ``accumulate``
    as ``unpack2bit_sum_op``'s (float32)."""
    if gathered.is_cuda:
        total = unpack2bit_wsum_cuda(gathered.contiguous(), weights.to(torch.float32).contiguous(),
                                     out=out, accumulate=accumulate)
    else:
        total = unpack2bit_wsum_ref(gathered, weights, out=out, accumulate=accumulate)
    return from_2d(total, n, shape)
