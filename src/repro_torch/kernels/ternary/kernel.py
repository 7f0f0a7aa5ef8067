"""Launch wrappers of the hand-written ternary kernels (``csrc/ternary.cu``),
which replace ``repro/kernels/ternary/kernel.py:ternary_compress_2d`` and its
fused 2-bit wire variant ``:ternary_pack2bit_2d``."""

from __future__ import annotations

import torch

from repro_torch.core.prng import MASK32
from repro_torch.kernels import build
from repro_torch.kernels.common import check_cuda_tensor, map_args, packed_shape
from repro_torch.kernels.ternary.rules import RULES

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rule name -> the kernel's template id (RULES' order, as csrc/ternary.cu has it)
RULE_IDS = {name: i for i, name in enumerate(RULES)}


def ternary_cuda(g: torch.Tensor, param: torch.Tensor, seeds: torch.Tensor,
                 counter_base: int = 0, *, rule: str, counter_map=None) -> torch.Tensor:
    """int8 RULES[rule] symbols of ``g`` (rows, ...) on the card, one launch
    for all rows.

    ``seeds``: int64 CUDA tensor of ``rows`` uint32 stream seeds, row r of ``g``
    drawing counters ``counter_base + j``. ``param``: float32 CUDA tensor with
    one value for all rows or one per row (the rule's budget, sigma or scale).
    ``counter_map`` (run, leaf_run, offset): each row is a model rank's slice
    of a leaf, drawing the whole leaf's counters
    (``kernels.common.counter_index``; ``ternary_map_launch``, counted in
    ``map_launches`` too). Allocates the output, launches on the current
    stream and does not synchronise."""
    if rule not in RULE_IDS:
        raise ValueError(f"unknown ternary rule {rule!r}; known: {sorted(RULE_IDS)}")
    check_cuda_tensor("g", g, tuple(_DTYPES))
    check_cuda_tensor("seeds", seeds, (torch.int64,))
    check_cuda_tensor("param", param, (torch.float32,))
    rows = seeds.numel()
    if rows < 1 or g.numel() % rows or (g.dim() > 0 and rows > 1 and g.shape[0] != rows):
        raise ValueError(f"{rows} seeds do not split g of shape {tuple(g.shape)} into rows")
    if param.numel() not in (1, rows):
        raise ValueError(f"param needs 1 or {rows} values, got {param.numel()}")
    out = torch.empty(g.shape, dtype=torch.int8, device=g.device)
    per_row = int(param.numel() == rows and rows > 1)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    if counter_map is None:
        err = build.library("ternary")(
            g.data_ptr(), out.data_ptr(), seeds.data_ptr(), param.data_ptr(), per_row, rows,
            g.numel() // rows, int(counter_base) & MASK32, _DTYPES[g.dtype], RULE_IDS[rule],
            stream)
    else:
        base, run, skip = map_args(counter_base, counter_map)
        err = build.library("ternary", "ternary_map_launch")(
            g.data_ptr(), out.data_ptr(), seeds.data_ptr(), param.data_ptr(), per_row, rows,
            g.numel() // rows, base, run, skip, _DTYPES[g.dtype], RULE_IDS[rule], stream)
    build.check_launch("ternary", err)
    ternary_cuda.launches += 1
    ternary_cuda.map_launches += counter_map is not None
    return out


ternary_cuda.launches = 0
ternary_cuda.map_launches = 0


def ternary_pack2bit_cuda(g: torch.Tensor, param: torch.Tensor, seed: torch.Tensor,
                          counter_base: int = 0, *, rule: str,
                          counter_map=None) -> torch.Tensor:
    """The (canonical_rows(n), 128) uint8 packed wire of RULES[rule](g) on
    the card, one launch; coordinates past g's end pack as 0. ``seed``: int64
    CUDA tensor of one uint32 stream seed over g's flat index; ``param``:
    float32 CUDA tensor of one value. ``counter_map`` (run, leaf_run,
    offset): g is a model rank's slice of a leaf, drawing the
    whole leaf's counters. Allocates the output, launches on the current
    stream and does not synchronise."""
    if rule not in RULE_IDS:
        raise ValueError(f"unknown ternary rule {rule!r}; known: {sorted(RULE_IDS)}")
    check_cuda_tensor("g", g, tuple(_DTYPES))
    check_cuda_tensor("seed", seed, (torch.int64,))
    check_cuda_tensor("param", param, (torch.float32,))
    if seed.numel() != 1 or param.numel() != 1:
        raise ValueError(f"one seed and one param per message, got {seed.numel()} "
                         f"and {param.numel()}")
    n = g.numel()
    out = torch.empty(packed_shape(n), dtype=torch.uint8, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    if counter_map is None:
        err = build.library("ternary", "ternary_pack2bit_launch")(
            g.data_ptr(), out.data_ptr(), seed.data_ptr(), param.data_ptr(), n, out.shape[0],
            int(counter_base) & MASK32, _DTYPES[g.dtype], RULE_IDS[rule], stream)
    else:
        base, run, skip = map_args(counter_base, counter_map)
        err = build.library("ternary", "ternary_pack2bit_map_launch")(
            g.data_ptr(), out.data_ptr(), seed.data_ptr(), param.data_ptr(), n, out.shape[0],
            base, run, skip, _DTYPES[g.dtype], RULE_IDS[rule], stream)
    build.check_launch("ternary_pack2bit", err)
    ternary_pack2bit_cuda.launches += 1
    ternary_pack2bit_cuda.map_launches += counter_map is not None
    return out


ternary_pack2bit_cuda.launches = 0
ternary_pack2bit_cuda.map_launches = 0
