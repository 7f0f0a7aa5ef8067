"""Plain PyTorch version of the fused sparsign -> 2-bit wire kernel, bit for
bit ``repro.kernels.sparsign_pack2bit.ref``: the two-pass composition, sparsign
then pack2bit over the canonical view."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import to_2d
from repro_torch.kernels.pack2bit.ref import pack2bit_ref
from repro_torch.kernels.sparsign.ref import sparsign_ref


def sparsign_pack2bit_ref(g: torch.Tensor, budget, seed, counter_base=0, *,
                          counter_map=None) -> torch.Tensor:
    """(any shape) -> (rows, 128) uint8 packed canonical wire of sparsign(g)."""
    view, _ = to_2d(sparsign_ref(g, budget, seed, counter_base,
                                 counter_map=counter_map).reshape(-1))
    return pack2bit_ref(view)
