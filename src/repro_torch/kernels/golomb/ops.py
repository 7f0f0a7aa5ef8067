"""Public ops of the Golomb/Rice entropy-coded wire: the CUDA kernels for
tensors on the card, the plain versions for tensors on the CPU.

``sparsign_golomb_op`` has the registry's ``fused_pack_op`` signature
``(g, budget, seed, counter_base)``; the plan-time nonzero fraction ``p`` is
keyword-only with the paper-regime default, and the wire passes its own.
The capacity (the output's row count) is ``ref.golomb_rows(g.numel(), p)``,
the wire ledger's rule."""

from __future__ import annotations

import torch

from repro_torch.core.prng import MASK32
from repro_torch.kernels.common import device_tensor
from repro_torch.kernels.golomb.kernel import (golomb_pack_cuda, sparsign_golomb_cuda,
                                               ungolomb_sum_cuda, ungolomb_wsum_cuda)
from repro_torch.kernels.golomb.ref import (golomb_encode_ref, golomb_rows, rice_b,
                                            ungolomb_sum_ref, ungolomb_wsum_ref)
from repro_torch.kernels.sparsign.ref import sparsign_ref

#: default plan-time nonzero fraction (the paper's 5% regime)
DEFAULT_P = 0.05


def sparsign_golomb_op(g: torch.Tensor, budget, seed, counter_base=0, *,
                       p: float = DEFAULT_P) -> torch.Tensor:
    """The (golomb_rows(n, p), 128) uint8 coded wire of sparsign(g) (any
    shape, f32/bf16): the same bytes as ``golomb_pack_op(sparsign_op(g, ...))``.
    ``seed`` is one stream seed over g's flat index and ``budget`` one value
    (a host number or a device scalar)."""
    n = g.numel()
    if not g.is_cuda:
        return golomb_encode_ref(sparsign_ref(g, budget, seed, counter_base), p=p)
    s = device_tensor(seed, g, torch.int64).reshape(-1) & MASK32
    bud = device_tensor(budget, g).reshape(-1)
    return sparsign_golomb_cuda(g.contiguous().reshape(-1), bud.contiguous(), s.contiguous(),
                                counter_base, b=rice_b(p), rows=golomb_rows(n, p))


def golomb_pack_op(t: torch.Tensor, *, p: float = DEFAULT_P) -> torch.Tensor:
    """The coded wire of an int8 ternary message (any shape): the second call
    of the two-pass chain, byte for byte the fused op."""
    if not t.is_cuda:
        return golomb_encode_ref(t, p=p)
    flat = t.to(torch.int8).contiguous().reshape(-1)
    return golomb_pack_cuda(flat, b=rice_b(p), rows=golomb_rows(flat.numel(), p))


def ungolomb_sum_op(gathered: torch.Tensor, size: int, shape, *,
                    p: float = DEFAULT_P) -> torch.Tensor:
    """(M, rows, 128) gathered coded messages -> int32 vote sum of ``shape``."""
    if not gathered.is_cuda:
        return ungolomb_sum_ref(gathered, size, shape, p=p)
    return ungolomb_sum_cuda(gathered.contiguous(), size, b=rice_b(p)).reshape(shape)


def ungolomb_wsum_op(gathered: torch.Tensor, weights: torch.Tensor, size: int, shape, *,
                     p: float = DEFAULT_P) -> torch.Tensor:
    """(M, rows, 128) gathered coded messages + (M,) float32 weights ->
    float32 ``sum_m weights[m] * votes_m`` of ``shape``."""
    if not gathered.is_cuda:
        return ungolomb_wsum_ref(gathered, weights, size, shape, p=p)
    return ungolomb_wsum_cuda(gathered.contiguous(), weights.to(torch.float32).contiguous(),
                              size, b=rice_b(p)).reshape(shape)
