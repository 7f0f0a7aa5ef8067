"""Launch wrappers of the hand-written 8-bit QSGD wire kernels
(``csrc/pack8.cu``), which replace
``repro/kernels/pack8/kernel.py:qsgd8_pack8_2d`` and ``:unpack8_sum_2d``."""

from __future__ import annotations

import torch

from repro_torch.core.prng import MASK32
from repro_torch.kernels import build
from repro_torch.kernels.common import (LANES, canonical_rows, check_cuda_tensor,
                                       decode_sum_out, map_args)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def qsgd8_pack8_cuda(g: torch.Tensor, param: torch.Tensor, seed: torch.Tensor,
                     counter_base: int = 0, counter_map=None) -> torch.Tensor:
    """The (canonical_rows(n), 512) int8 pack8 wire of qsgd8(g) on the card,
    one launch: the signed stochastic levels of g's flat stream, the pad
    rows 0. ``seed``: int64 CUDA tensor of one uint32 stream seed, drawing
    counters ``counter_base + j``; ``param``: float32 CUDA tensor of one
    value, the decode scale. ``counter_map`` (run, leaf_run, offset): g
    is a model rank's slice of a leaf, drawing the whole leaf's
    counters. Allocates the output, launches on the current stream and does
    not synchronise."""
    check_cuda_tensor("g", g, tuple(_DTYPES))
    check_cuda_tensor("seed", seed, (torch.int64,))
    check_cuda_tensor("param", param, (torch.float32,))
    if seed.numel() != 1 or param.numel() != 1:
        raise ValueError(f"one seed and one scale per message, got {seed.numel()} and "
                         f"{param.numel()}")
    n = g.numel()
    out = torch.empty((canonical_rows(n), LANES), dtype=torch.int8, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    if counter_map is None:
        err = build.library("pack8", "qsgd8_pack8_launch")(
            g.data_ptr(), out.data_ptr(), seed.data_ptr(), param.data_ptr(), n, out.shape[0],
            int(counter_base) & MASK32, _DTYPES[g.dtype], stream)
    else:
        base, run, skip = map_args(counter_base, counter_map)
        err = build.library("pack8", "qsgd8_pack8_map_launch")(
            g.data_ptr(), out.data_ptr(), seed.data_ptr(), param.data_ptr(), n, out.shape[0],
            base, run, skip, _DTYPES[g.dtype], stream)
    build.check_launch("qsgd8_pack8", err)
    qsgd8_pack8_cuda.launches += 1
    return out


qsgd8_pack8_cuda.launches = 0


def unpack8_sum_cuda(gathered: torch.Tensor, scales: torch.Tensor, *, out=None,
                     accumulate: bool = False) -> torch.Tensor:
    """(M, rows, 512) int8 gathered levels + (M,) float32 CUDA scales ->
    (rows, 512) float32 ``sum_m scales[m] * levels[m]`` on the card, in
    worker order from +0.0, or from ``out``'s values with ``accumulate``; a
    new tensor or ``out``; one launch, no synchronisation."""
    check_cuda_tensor("gathered", gathered, (torch.int8,))
    check_cuda_tensor("scales", scales, (torch.float32,))
    if gathered.dim() != 3 or gathered.shape[2] != LANES:
        raise ValueError(f"gathered must be (M, rows, {LANES}) level views, got shape "
                         f"{tuple(gathered.shape)}")
    m, rows, _ = gathered.shape
    if scales.numel() != m:
        raise ValueError(f"{m} messages need {m} scales, got {scales.numel()}")
    total = decode_sum_out(out, (rows, LANES), torch.float32, (torch.float32,), accumulate,
                           gathered.device)
    err = build.library("pack8", "unpack8_sum_into_launch")(
        gathered.data_ptr(), scales.data_ptr(), total.data_ptr(), m, rows, int(accumulate),
        torch.cuda.current_stream(gathered.device).cuda_stream)
    build.check_launch("unpack8_sum", err)
    unpack8_sum_cuda.launches += 1
    return total


unpack8_sum_cuda.launches = 0
