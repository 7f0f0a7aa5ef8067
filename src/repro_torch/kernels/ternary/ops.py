"""Public ternary ops: the CUDA kernel for a tensor on the card, the plain
version for a tensor on the CPU. The named partials are what the compressor
registry installs as ``kernel_op`` and ``fused_pack_op``, as
``repro.kernels.ternary.ops`` names them; every entry shares the signature
``(g, param, seed, counter_base)``."""

from __future__ import annotations

from functools import partial

import torch

from repro_torch.core.prng import MASK32
from repro_torch.kernels.common import device_tensor
from repro_torch.kernels.ternary.kernel import ternary_cuda, ternary_pack2bit_cuda
from repro_torch.kernels.ternary.ref import ternary_compress_ref, ternary_pack2bit_ref


def ternary_compress_op(g: torch.Tensor, param, seed, counter_base=0, *,
                        rule: str, counter_map=None) -> torch.Tensor:
    """int8 ternary RULES[rule] symbols of ``g`` (f32/bf16). ``seed`` is one
    stream seed over g's flat index, or a 1-D sequence of per-row seeds for g
    of shape (rows, ...); ``param`` is a scalar or one value per row. A
    model rank's slice (``counter_map``) has no kernel here yet: on the card
    it raises."""
    if not g.is_cuda:
        return ternary_compress_ref(g, param, seed, counter_base, rule=rule,
                                    counter_map=counter_map)
    if counter_map is not None:
        raise NotImplementedError("the flat ternary kernel's counter map (a model rank's "
                                  "slice) is not ported yet: use the allgather_packed wire")
    seeds = device_tensor(seed, g, torch.int64).reshape(-1) & MASK32
    p = device_tensor(param, g).reshape(-1)
    return ternary_cuda(g.contiguous(), p.contiguous(), seeds, counter_base, rule=rule)


def ternary_pack2bit_op(g: torch.Tensor, param, seed, counter_base=0, *,
                        rule: str, counter_map=None) -> torch.Tensor:
    """The (rows, 128) uint8 2-bit packed wire of RULES[rule](g), fused: the
    same bytes as packing ``ternary_compress_op(g, ...)``, with coordinates
    past g's end packed as 0 (noisy_sign's rule is nonzero at zero input).
    ``seed`` is one stream seed over g's flat index, ``param`` one value."""
    if not g.is_cuda:
        return ternary_pack2bit_ref(g, param, seed, counter_base, rule=rule,
                                    counter_map=counter_map)
    s = device_tensor(seed, g, torch.int64).reshape(-1) & MASK32
    p = device_tensor(param, g).reshape(-1)
    return ternary_pack2bit_cuda(g.contiguous(), p.contiguous(), s.contiguous(), counter_base,
                                 rule=rule, counter_map=counter_map)


sign_op = partial(ternary_compress_op, rule="sign")
sign_pack2bit_op = partial(ternary_pack2bit_op, rule="sign")
noisy_sign_op = partial(ternary_compress_op, rule="noisy_sign")
noisy_sign_pack2bit_op = partial(ternary_pack2bit_op, rule="noisy_sign")
stochastic_ternary_op = partial(ternary_compress_op, rule="stochastic_ternary")
stochastic_ternary_pack2bit_op = partial(ternary_pack2bit_op, rule="stochastic_ternary")
