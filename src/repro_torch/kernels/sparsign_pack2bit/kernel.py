"""Launch wrapper of the hand-written fused sparsign -> 2-bit wire kernel
(``csrc/sparsign_pack2bit.cu``), which replaces
``repro/kernels/sparsign_pack2bit/kernel.py:sparsign_pack2bit_2d``."""

from __future__ import annotations

import torch

from repro_torch.core.prng import MASK32
from repro_torch.kernels import build
from repro_torch.kernels.common import check_cuda_tensor, map_args, packed_shape

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def sparsign_pack2bit_cuda(g: torch.Tensor, budget: torch.Tensor, seed: torch.Tensor,
                           counter_base: int = 0, counter_map=None) -> torch.Tensor:
    """The (canonical_rows(n), 128) uint8 packed wire of sparsign(g) on the
    card, one launch. ``seed``: int64 CUDA tensor of one uint32 stream seed,
    drawing counters ``counter_base + j`` over g's flat index; ``budget``:
    float32 CUDA tensor of one value. ``counter_map`` (run, leaf_run,
    offset): g is a model rank's slice of a leaf, drawing the
    whole leaf's counters. Allocates the output, launches on the current
    stream and does not synchronise."""
    check_cuda_tensor("g", g, tuple(_DTYPES))
    check_cuda_tensor("seed", seed, (torch.int64,))
    check_cuda_tensor("budget", budget, (torch.float32,))
    if seed.numel() != 1 or budget.numel() != 1:
        raise ValueError(f"one seed and one budget per message, got {seed.numel()} "
                         f"and {budget.numel()}")
    n = g.numel()
    out = torch.empty(packed_shape(n), dtype=torch.uint8, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    if counter_map is None:
        err = build.library("sparsign_pack2bit")(
            g.data_ptr(), out.data_ptr(), seed.data_ptr(), budget.data_ptr(), n, out.shape[0],
            int(counter_base) & MASK32, _DTYPES[g.dtype], stream)
    else:
        base, run, skip = map_args(counter_base, counter_map)
        err = build.library("sparsign_pack2bit", "sparsign_pack2bit_map_launch")(
            g.data_ptr(), out.data_ptr(), seed.data_ptr(), budget.data_ptr(), n, out.shape[0],
            base, run, skip, _DTYPES[g.dtype], stream)
    build.check_launch("sparsign_pack2bit", err)
    sparsign_pack2bit_cuda.launches += 1
    sparsign_pack2bit_cuda.map_launches += counter_map is not None
    return out


sparsign_pack2bit_cuda.launches = 0
sparsign_pack2bit_cuda.map_launches = 0
