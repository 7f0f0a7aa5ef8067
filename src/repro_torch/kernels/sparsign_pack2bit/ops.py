"""Public fused sparsign -> 2-bit wire op: the CUDA kernel for a tensor on
the card, the plain two-pass version for a tensor on the CPU."""

from __future__ import annotations

import torch

from repro_torch.core.prng import MASK32
from repro_torch.kernels.common import device_tensor
from repro_torch.kernels.sparsign_pack2bit.kernel import sparsign_pack2bit_cuda
from repro_torch.kernels.sparsign_pack2bit.ref import sparsign_pack2bit_ref


def sparsign_pack2bit_op(g: torch.Tensor, budget, seed, counter_base=0, *,
                         counter_map=None) -> torch.Tensor:
    """2-bit packed sparsign wire of ``g`` (any shape, f32/bf16): the
    (rows, 128) uint8 canonical view, the same bytes as packing
    ``sparsign_op(g, ...)``. ``seed`` is one stream seed over g's flat index
    and ``budget`` one value (a host number or a device scalar);
    ``counter_map`` as ``sparsign_op`` takes it."""
    if not g.is_cuda:
        return sparsign_pack2bit_ref(g, budget, seed, counter_base, counter_map=counter_map)
    s = device_tensor(seed, g, torch.int64).reshape(-1) & MASK32
    b = device_tensor(budget, g).reshape(-1)
    return sparsign_pack2bit_cuda(g.contiguous(), b.contiguous(), s.contiguous(), counter_base,
                                  counter_map)
