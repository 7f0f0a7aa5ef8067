"""Gradient compressors and the ``CompressorSpec`` registry, the port of
``repro.core.compressors`` for this slice: the paper's ``sparsign`` (Def. 1)
and the uncompressed ``identity`` baseline. The other rows arrive with their
kernels; ``get_spec`` names the ROADMAP queue for them.

Values functions share the normalized signature
``(g, param, seed, counter_base) -> values``, where ``seed`` is one stream
seed or a 1-D tensor of per-worker seeds for g of shape (workers, ...), and
``param`` the budget, a scalar or one per row.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import torch

from repro_torch.kernels.sparsign.ops import sparsign_op
from repro_torch.kernels.ternary.ref import as_rows, ternary_compress_ref


@dataclasses.dataclass(frozen=True)
class CompressedGrad:
    """values: int8 ternary {-1,0,+1} or a float payload. scale: the decode
    multiplier (1.0 for the scale-free sparsign)."""

    values: torch.Tensor
    scale: torch.Tensor

    def decode(self) -> torch.Tensor:
        return self.values.to(torch.float32) * self.scale


_sparsign_values = partial(ternary_compress_ref, rule="sparsign")


def _identity_values(g, param, seed, counter_base):
    return g


@dataclasses.dataclass(frozen=True)
class CompressorSpec:
    """One row of the compressor table, with the fields this slice reads.
    ``values`` is the plain version; ``kernel_op`` the op that launches the
    CUDA kernel for a tensor on the card (argument for argument the same).
    The wire and decode metadata of the JAX table arrive with the wires."""

    name: str
    values: Callable
    is_ternary: bool
    scale_protocol: str = "none"   # both rows are scale-free
    kernel_op: Optional[Callable] = None
    chunkable: bool = False
    uplink_bits: str = "dense_sign"


SPECS: dict[str, CompressorSpec] = {spec.name: spec for spec in (
    CompressorSpec(
        name="sparsign", values=_sparsign_values, is_ternary=True,
        kernel_op=sparsign_op, chunkable=True, uplink_bits="golomb_ternary"),
    CompressorSpec(
        name="identity", values=_identity_values, is_ternary=False, uplink_bits="fp32"),
)}

#: compressors of the JAX package that arrive with their kernels (ROADMAP.md,
#: queue 2 "TPU kernels to port", rows 4-6 and 12-14)
NOT_YET_PORTED = ("sparsign_golomb", "sign", "scaled_sign", "noisy_sign",
                  "qsgd_1bit_l2", "qsgd_1bit_linf", "terngrad", "qsgd8")


def get_spec(name: str) -> CompressorSpec:
    try:
        return SPECS[name]
    except KeyError:
        if name in NOT_YET_PORTED:
            raise KeyError(
                f"compressor {name!r} is not ported yet: it arrives with its kernel "
                f"(ROADMAP.md queue 2, 'TPU kernels to port'); ported: "
                f"{sorted(SPECS)}") from None
        raise KeyError(f"unknown compressor {name!r}; known: {sorted(SPECS)}") from None


def chunked_values(values_fn, g, param, seed, counter_base=0, max_chunk: int = 1 << 23):
    """Apply a counter-indexed values function in column chunks, which bounds
    the plain version's int64 counter and uniform buffers to ``max_chunk``
    elements. Stream-identical to one call: the counter is the column index."""
    rows, _ = as_rows(g, seed)
    if rows.numel() <= max_chunk:
        return values_fn(g, param, seed, counter_base)
    step = max(1, max_chunk // rows.shape[0])
    parts = [values_fn(rows[:, s:s + step].contiguous(), param, seed, int(counter_base) + s)
             for s in range(0, rows.shape[1], step)]
    return torch.cat([p.reshape(rows.shape[0], -1) for p in parts], dim=1).reshape(g.shape)
