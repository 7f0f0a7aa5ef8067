"""Launch wrappers of the hand-written Golomb/Rice wire kernels:
``csrc/golomb_encode.cu`` (replaces ``repro/kernels/golomb/kernel.py:sparsign_golomb_2d``
and ``:golomb_pack_2d``) and ``csrc/golomb_decode.cu`` (replaces ``:ungolomb_sum``
and ``:ungolomb_wsum``)."""

from __future__ import annotations

import torch

from repro_torch.core.prng import MASK32
from repro_torch.kernels import build
from repro_torch.kernels.common import check_cuda_tensor
from repro_torch.kernels.golomb.ref import ROW_BYTES

_SPARSIGN_SRC = {torch.float32: 0, torch.bfloat16: 1}
_TERNARY_SRC = 2


def _encode(src: torch.Tensor, kind: int, seed, budget, counter_base: int, b: int,
            rows: int) -> torch.Tensor:
    n = src.numel()
    if not 1 <= n < 2**31:
        raise ValueError(f"the golomb encoder takes 1 to 2^31 - 1 coordinates, got {n}")
    if not 0 <= b <= 31:
        raise ValueError(f"Rice parameter b must be in [0, 31], got {b}")
    out = torch.empty((rows, ROW_BYTES), dtype=torch.uint8, device=src.device)
    nbytes = build.library("golomb_encode", "golomb_encode_scratch_bytes")(n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=src.device)
    err = build.library("golomb_encode", "golomb_encode_launch")(
        src.data_ptr(), out.data_ptr(), None if seed is None else seed.data_ptr(),
        None if budget is None else budget.data_ptr(), scratch.data_ptr(), n, rows,
        int(counter_base) & MASK32, b, kind, torch.cuda.current_stream(src.device).cuda_stream)
    build.check_launch("golomb_encode", err)
    return out


def sparsign_golomb_cuda(g: torch.Tensor, budget: torch.Tensor, seed: torch.Tensor,
                         counter_base: int = 0, *, b: int, rows: int) -> torch.Tensor:
    """The (rows, 128) uint8 Golomb/Rice wire of sparsign(g) on the card, with
    Rice parameter b and capacity ``rows``: one call, no int8 intermediate.
    ``seed``: int64 CUDA tensor of one uint32 stream seed, drawing counters
    ``counter_base + j`` over g's flat index; ``budget``: float32 CUDA tensor
    of one value. Allocates the output and scratch, launches on the current
    stream and does not synchronise."""
    check_cuda_tensor("g", g, tuple(_SPARSIGN_SRC))
    check_cuda_tensor("seed", seed, (torch.int64,))
    check_cuda_tensor("budget", budget, (torch.float32,))
    if seed.numel() != 1 or budget.numel() != 1:
        raise ValueError(f"one seed and one budget per message, got {seed.numel()} "
                         f"and {budget.numel()}")
    out = _encode(g, _SPARSIGN_SRC[g.dtype], seed, budget, counter_base, b, rows)
    sparsign_golomb_cuda.launches += 1
    return out


sparsign_golomb_cuda.launches = 0


def golomb_pack_cuda(t: torch.Tensor, *, b: int, rows: int) -> torch.Tensor:
    """The (rows, 128) uint8 Golomb/Rice wire of an int8 ternary tensor on the
    card; one call, no synchronisation."""
    check_cuda_tensor("t", t, (torch.int8,))
    out = _encode(t, _TERNARY_SRC, None, None, 0, b, rows)
    golomb_pack_cuda.launches += 1
    return out


golomb_pack_cuda.launches = 0


def _check_gathered(gathered: torch.Tensor) -> None:
    check_cuda_tensor("gathered", gathered, (torch.uint8,))
    if gathered.dim() != 3 or gathered.shape[2] != ROW_BYTES:
        raise ValueError(f"gathered must be (M, rows, {ROW_BYTES}) coded messages, "
                         f"got shape {tuple(gathered.shape)}")
    if gathered.data_ptr() % 4:
        raise ValueError("gathered must be 4-byte aligned")


def _decode(gathered: torch.Tensor, weights, n: int, b: int, stats) -> torch.Tensor:
    if not 0 <= b <= 30:
        raise ValueError(f"Rice parameter b must be in [0, 30], got {b}")
    m, rows, _ = gathered.shape
    out = torch.empty(n, dtype=torch.int32 if weights is None else torch.float32,
                      device=gathered.device)
    nbytes = build.library("golomb_decode", "ungolomb_scratch_bytes")(m, rows, n, b)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=gathered.device)
    err = build.library("golomb_decode", "ungolomb_launch")(
        gathered.data_ptr(), None if weights is None else weights.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), None if stats is None else stats.data_ptr(), m, rows, n, b,
        torch.cuda.current_stream(gathered.device).cuda_stream)
    build.check_launch("ungolomb", err)
    return out


def ungolomb_sum_cuda(gathered: torch.Tensor, n: int, *, b: int, stats=None) -> torch.Tensor:
    """(M, rows, 128) uint8 gathered coded messages -> (n,) int32 vote sum on
    the card; one call, no synchronisation. ``stats``, an int64 CUDA tensor of
    one, receives the count of segments whose decoded exit is not the next
    segment's composed entry: 0 on any stream, which a caller can check."""
    _check_gathered(gathered)
    out = _decode(gathered, None, n, b, stats)
    ungolomb_sum_cuda.launches += 1
    return out


ungolomb_sum_cuda.launches = 0


def ungolomb_wsum_cuda(gathered: torch.Tensor, weights: torch.Tensor, n: int, *, b: int,
                       stats=None) -> torch.Tensor:
    """(M, rows, 128) uint8 gathered coded messages + (M,) float32 CUDA
    weights -> (n,) float32 ``sum_m w_m * votes_m`` on the card, accumulated
    from +0.0 in worker order; one call, no synchronisation."""
    _check_gathered(gathered)
    check_cuda_tensor("weights", weights, (torch.float32,))
    if weights.numel() != gathered.shape[0]:
        raise ValueError(f"{gathered.shape[0]} messages need {gathered.shape[0]} weights, "
                         f"got {weights.numel()}")
    out = _decode(gathered, weights, n, b, stats)
    ungolomb_wsum_cuda.launches += 1
    return out


ungolomb_wsum_cuda.launches = 0
