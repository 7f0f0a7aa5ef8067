"""Public ops of the 8-bit QSGD (``pack8``) wire: the CUDA kernels for a
tensor on the card, the plain versions for a tensor on the CPU.

``qsgd8_op``/``qsgd8_pack8_op`` share the registry's signature ``(g, param,
seed, counter_base)``: they are what the qsgd8 ``CompressorSpec`` installs as
``kernel_op`` and ``fused_pack_op``. The fused op's payload is the
wire-native canonical (rows, 512) int8 view; ``qsgd8_op`` unpads it back to
the leaf shape for the decoded path.
"""

from __future__ import annotations

import torch

from repro_torch.core.prng import MASK32
from repro_torch.kernels.common import device_tensor, from_2d
from repro_torch.kernels.pack8.kernel import qsgd8_pack8_cuda, unpack8_sum_cuda
from repro_torch.kernels.pack8.ref import qsgd8_pack8_ref, unpack8_sum_ref


def qsgd8_pack8_op(g: torch.Tensor, param, seed, counter_base=0, *,
                   counter_map=None) -> torch.Tensor:
    """Quantize -> 8-bit wire: (any shape, f32/bf16) -> (rows, 512) int8
    signed levels, one pass on the card, the bytes of
    ``to_2d(qsgd8_levels_ref(g, ...))``. ``seed`` is one stream seed over g's
    flat index and ``param`` the decode scale (a host number or a device
    scalar). ``counter_map``: g is a model rank's slice of a leaf, as
    ``sparsign_op`` takes it."""
    if not g.is_cuda:
        return qsgd8_pack8_ref(g, param, seed, counter_base, counter_map=counter_map)
    s = device_tensor(seed, g, torch.int64).reshape(-1) & MASK32
    p = device_tensor(param, g).reshape(-1)
    return qsgd8_pack8_cuda(g.contiguous(), p.contiguous(), s.contiguous(), counter_base,
                            counter_map)


def qsgd8_op(g: torch.Tensor, param, seed, counter_base=0, *,
             counter_map=None) -> torch.Tensor:
    """int8 signed qsgd8 levels in the leaf shape (the decoded-wire path)."""
    return from_2d(qsgd8_pack8_op(g, param, seed, counter_base, counter_map=counter_map),
                   g.numel(), g.shape)


def unpack8_sum_op(gathered: torch.Tensor, scales: torch.Tensor, n: int, shape, *, out=None,
                   accumulate: bool = False) -> torch.Tensor:
    """(M, rows, 512) gathered int8 levels + (M,) float32 scales -> float32
    ``sum_m scales[m] * levels[m]`` in ``shape``, in worker order: the decode
    side of the pack8 all-gather wire. With ``out`` (rows x 512 float32) the
    sum is written there, or with ``accumulate`` added into it: the ring's
    hop."""
    if gathered.is_cuda:
        total = unpack8_sum_cuda(gathered.contiguous(), scales.to(torch.float32).contiguous(),
                                 out=out, accumulate=accumulate)
    else:
        total = unpack8_sum_ref(gathered, scales, out=out, accumulate=accumulate)
    return from_2d(total, n, shape)
