"""Plain PyTorch oracle of the ternary compressors, bit for bit
``repro.kernels.ternary.ref.ternary_compress_ref``.

``seed`` is one stream seed (an int or 0-d tensor), with ``g`` of any shape
and counters running over its flat index; or a 1-D tensor of per-worker
seeds, with ``g`` of shape (workers, ...) and every row's counters starting
at ``counter_base`` (the batched form of ``jax.vmap`` over workers). ``param``
is a scalar or one value per row: the budget, sigma or scale of the rule.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.kernels.common import counter_index, device_tensor, to_2d
from repro_torch.kernels.pack2bit.ref import pack2bit_ref
from repro_torch.kernels.ternary.rules import RULES


def as_rows(g: torch.Tensor, seed):
    """(g as (rows, n), seeds as an int64 (rows, 1) tensor) for ``seed`` in
    either of the two forms above."""
    seeds = device_tensor(seed, g, torch.int64)
    if seeds.dim() == 0:
        return g.reshape(1, -1), seeds.reshape(1, 1)
    if seeds.dim() != 1 or g.dim() == 0 or g.shape[0] != seeds.shape[0]:
        raise ValueError(f"per-row seeds of shape {tuple(seeds.shape)} need g of "
                         f"shape (rows, ...), got {tuple(g.shape)}")
    return g.reshape(seeds.shape[0], -1), seeds.reshape(-1, 1)


def ternary_compress_ref(g: torch.Tensor, param, seed, counter_base=0, *,
                         rule: str, counter_map=None) -> torch.Tensor:
    """int8 ternary RULES[rule] symbols, shaped like ``g``; with
    ``counter_map`` each row is a model rank's slice drawing the whole leaf's
    counters (``kernels.common.counter_index``)."""
    fn = RULES[rule]
    rows, seeds = as_rows(g.to(torch.float32), seed)
    idx = counter_index(rows.shape[1], counter_base, g.device, counter_map)

    def u(salt: int):
        s = seeds if salt == 0 else prng.fold_seed(seeds, salt)
        return prng.uniform01(s, idx)

    prm = device_tensor(param, g).reshape(-1, 1)
    sym = fn(rows, u, prm)
    # a NaN symbol (sign of a NaN input) is 0, as XLA's convert gives it;
    # the float -> int8 cast itself leaves NaN undefined
    sym = torch.where(torch.isnan(sym), torch.zeros((), device=g.device), sym)
    return sym.to(torch.int8).reshape(g.shape)


def ternary_pack2bit_ref(g: torch.Tensor, param, seed, counter_base=0, *,
                         rule: str, counter_map=None) -> torch.Tensor:
    """The (rows, 128) uint8 packed canonical wire of RULES[rule](g): the
    two-pass composition; the canonical pad is zeros after the rule, so
    coordinates past g's end pack as 0."""
    view, _ = to_2d(ternary_compress_ref(g, param, seed, counter_base, rule=rule,
                                         counter_map=counter_map).reshape(-1))
    return pack2bit_ref(view)
