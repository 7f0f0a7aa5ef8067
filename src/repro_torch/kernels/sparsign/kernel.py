"""Launch wrapper of the hand-written sparsign kernel (``csrc/sparsign.cu``),
which replaces ``repro/kernels/sparsign/kernel.py:sparsign_2d``."""

from __future__ import annotations

import torch

from repro_torch.core.prng import MASK32
from repro_torch.kernels import build
from repro_torch.kernels.common import check_cuda_tensor, map_args

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def sparsign_cuda(g: torch.Tensor, budget: torch.Tensor, seeds: torch.Tensor,
                  counter_base: int = 0, counter_map=None) -> torch.Tensor:
    """int8 sparsign of ``g`` (rows, ...) on the card, one launch for all rows.

    ``seeds``: int64 CUDA tensor of ``rows`` uint32 stream seeds, row r of ``g``
    drawing counters ``counter_base + j``. ``budget``: float32 CUDA tensor with
    one value for all rows or one per row. ``counter_map`` (run, leaf_run,
    offset): each row is a model rank's slice of a leaf, drawing the whole
    leaf's counters (``kernels.common.counter_index``). Allocates the output,
    launches on the current stream and does not synchronise."""
    check_cuda_tensor("g", g, tuple(_DTYPES))
    check_cuda_tensor("seeds", seeds, (torch.int64,))
    check_cuda_tensor("budget", budget, (torch.float32,))
    rows = seeds.numel()
    if rows < 1 or g.numel() % rows or (g.dim() > 0 and rows > 1 and g.shape[0] != rows):
        raise ValueError(f"{rows} seeds do not split g of shape {tuple(g.shape)} into rows")
    if budget.numel() not in (1, rows):
        raise ValueError(f"budget needs 1 or {rows} values, got {budget.numel()}")
    out = torch.empty(g.shape, dtype=torch.int8, device=g.device)
    per_row = int(budget.numel() == rows and rows > 1)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    if counter_map is None:
        err = build.library("sparsign")(
            g.data_ptr(), out.data_ptr(), seeds.data_ptr(), budget.data_ptr(), per_row, rows,
            g.numel() // rows, int(counter_base) & MASK32, _DTYPES[g.dtype], stream)
    else:
        base, run, skip = map_args(counter_base, counter_map)
        err = build.library("sparsign", "sparsign_map_launch")(
            g.data_ptr(), out.data_ptr(), seeds.data_ptr(), budget.data_ptr(), per_row, rows,
            g.numel() // rows, base, run, skip, _DTYPES[g.dtype], stream)
    build.check_launch("sparsign", err)
    sparsign_cuda.launches += 1
    return out


sparsign_cuda.launches = 0
