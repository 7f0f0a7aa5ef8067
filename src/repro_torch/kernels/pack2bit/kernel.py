"""Launch wrappers of the hand-written 2-bit wire kernels: the stand-alone
pack and unpack (``csrc/pack2bit.cu``), which replace
``repro/kernels/pack2bit/kernel.py:pack2bit_2d`` and ``:unpack2bit_2d``, and
the decode-sums (``csrc/unpack2bit.cu``), which replace ``:unpack2bit_sum_2d``
and ``:unpack2bit_wsum_2d``."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (LANES, PACKED_WIDTH, check_cuda_tensor, decode_sum_out,
                                        packed_shape)
from repro_torch.kernels.pack2bit.ref import SUM_DTYPES


def pack2bit_cuda(t: torch.Tensor) -> torch.Tensor:
    """int8 ternary ``t`` (any shape, read as its flat stream) -> the
    (canonical_rows(n), 128) uint8 packed canonical view on the card, one
    launch; coordinates past n pack as 0. Allocates the output, launches on
    the current stream and does not synchronise."""
    check_cuda_tensor("t", t, (torch.int8,))
    n = t.numel()
    out = torch.empty(packed_shape(n), dtype=torch.uint8, device=t.device)
    err = build.library("pack2bit", "pack2bit_launch")(
        t.data_ptr(), out.data_ptr(), n, out.shape[0],
        torch.cuda.current_stream(t.device).cuda_stream)
    build.check_launch("pack2bit", err)
    pack2bit_cuda.launches += 1
    return out


pack2bit_cuda.launches = 0


def unpack2bit_cuda(packed: torch.Tensor) -> torch.Tensor:
    """(rows, 128) uint8 packed view -> (rows, 512) int8 ternary view on the
    card, one launch, no synchronisation."""
    check_cuda_tensor("packed", packed, (torch.uint8,))
    if packed.dim() != 2 or packed.shape[1] != PACKED_WIDTH:
        raise ValueError(f"packed must be (rows, {PACKED_WIDTH}), got shape "
                         f"{tuple(packed.shape)}")
    rows = packed.shape[0]
    out = torch.empty((rows, LANES), dtype=torch.int8, device=packed.device)
    err = build.library("pack2bit", "unpack2bit_launch")(
        packed.data_ptr(), out.data_ptr(), rows,
        torch.cuda.current_stream(packed.device).cuda_stream)
    build.check_launch("unpack2bit", err)
    unpack2bit_cuda.launches += 1
    return out


unpack2bit_cuda.launches = 0


def _check_gathered(gathered: torch.Tensor) -> None:
    check_cuda_tensor("gathered", gathered, (torch.uint8,))
    if gathered.dim() != 3 or gathered.shape[2] != PACKED_WIDTH:
        raise ValueError(f"gathered must be (M, rows, {PACKED_WIDTH}) packed messages, "
                         f"got shape {tuple(gathered.shape)}")
    if gathered.data_ptr() % 4:
        raise ValueError("gathered must be 4-byte aligned")


def unpack2bit_sum_cuda(gathered: torch.Tensor, *, out=None,
                        accumulate: bool = False) -> torch.Tensor:
    """(M, rows, 128) uint8 gathered packed messages -> (rows, 512) vote sum
    on the card, one launch: a new int32 tensor, or written into ``out``
    (rows x 512 int8, int16 or int32 on the card) or, with ``accumulate``,
    added into it. Launches on the current stream and does not
    synchronise."""
    _check_gathered(gathered)
    m, rows, _ = gathered.shape
    total = decode_sum_out(out, (rows, LANES), torch.int32, SUM_DTYPES, accumulate,
                           gathered.device)
    err = build.library("unpack2bit", "unpack2bit_sum_into_launch")(
        gathered.data_ptr(), total.data_ptr(), m, rows, total.element_size(), int(accumulate),
        torch.cuda.current_stream(gathered.device).cuda_stream)
    build.check_launch("unpack2bit_sum", err)
    unpack2bit_sum_cuda.launches += 1
    return total


unpack2bit_sum_cuda.launches = 0


def unpack2bit_wsum_cuda(gathered: torch.Tensor, weights: torch.Tensor, *, out=None,
                         accumulate: bool = False) -> torch.Tensor:
    """(M, rows, 128) uint8 gathered packed messages + (M,) float32 CUDA
    weights -> (rows, 512) float32 ``sum_m w_m * votes_m`` on the card,
    accumulated in worker order from +0.0, or from ``out``'s values with
    ``accumulate``; a new tensor or ``out``; one launch, no
    synchronisation."""
    _check_gathered(gathered)
    check_cuda_tensor("weights", weights, (torch.float32,))
    m, rows, _ = gathered.shape
    if weights.numel() != m:
        raise ValueError(f"{m} messages need {m} weights, got {weights.numel()}")
    total = decode_sum_out(out, (rows, LANES), torch.float32, (torch.float32,), accumulate,
                           gathered.device)
    err = build.library("unpack2bit", "unpack2bit_wsum_into_launch")(
        gathered.data_ptr(), weights.data_ptr(), total.data_ptr(), m, rows, int(accumulate),
        torch.cuda.current_stream(gathered.device).cuda_stream)
    build.check_launch("unpack2bit_wsum", err)
    unpack2bit_wsum_cuda.launches += 1
    return total


unpack2bit_wsum_cuda.launches = 0
