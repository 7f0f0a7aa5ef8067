"""Plain PyTorch version of the sparsign kernel (Def. 1), bit for bit
``repro.kernels.sparsign.ref.sparsign_ref``: the same counter-hash stream,
float32 threshold and clipping. The CPU path and the card's comparison."""

from __future__ import annotations

import torch

from repro_torch.kernels.ternary.ref import ternary_compress_ref


def sparsign_ref(g: torch.Tensor, budget, seed, counter_base=0, *,
                 counter_map=None) -> torch.Tensor:
    """int8 ternary sparsign of ``g``; ``seed``, ``budget`` and
    ``counter_map`` per ``ternary_compress_ref`` (one stream, or one per row)."""
    return ternary_compress_ref(g, budget, seed, counter_base, rule="sparsign",
                                counter_map=counter_map)
