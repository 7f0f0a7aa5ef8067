"""Public sparsign op: the CUDA kernel for a tensor on the card, the plain
version for a tensor on the CPU."""

from __future__ import annotations

import torch

from repro_torch.core.prng import MASK32
from repro_torch.kernels.common import device_tensor
from repro_torch.kernels.sparsign.kernel import sparsign_cuda
from repro_torch.kernels.sparsign.ref import sparsign_ref


def sparsign_op(g: torch.Tensor, budget, seed, counter_base=0, *,
                counter_map=None) -> torch.Tensor:
    """int8 ternary sparsign of ``g`` (f32/bf16). ``seed`` is one stream seed
    over g's flat index, or a 1-D sequence of per-row seeds for g of shape
    (rows, ...); ``budget`` is a scalar or one value per row; ``counter_map``
    (run, leaf_run, offset) makes each row a model rank's slice of a leaf."""
    if not g.is_cuda:
        return sparsign_ref(g, budget, seed, counter_base, counter_map=counter_map)
    seeds = device_tensor(seed, g, torch.int64).reshape(-1) & MASK32
    b = device_tensor(budget, g).reshape(-1)
    return sparsign_cuda(g.contiguous(), b.contiguous(), seeds, counter_base, counter_map)
