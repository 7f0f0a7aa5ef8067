"""Plain PyTorch versions of the 8-bit QSGD (``pack8``) wire, bit for bit
``repro.kernels.pack8.ref``.

Wire format: the canonical (rows, LANES) int8 view of the signed stochastic
levels, 1 B a coordinate, plus one float32 decode scale per (worker, leaf).
The int8 payload is the wire's byte stream: packing is the canonical view's
zero padding.

Level rule (FedCom-style 8-bit QSGD, s = 127 = 1 sign bit + 7 level bits)::

    r     = |g| / max(param, 1e-20)        # param = max(||g||_2, eps) / 127
    level = min(floor(r) + Bern(r - floor(r)), 127)

The clip at 127 keeps sign * level inside int8: r can pass s by a float ulp
when one coordinate carries the whole norm. A NaN gradient quantizes to 0, as
XLA's float -> int8 convert gives it.

The decode (``unpack8_sum_ref``) adds the workers' decoded messages from +0.0
strictly in worker order, each product rounded before its add: the
association of the decoded-psum wire, so the two wires agree bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.kernels.common import counter_index, decode_sum_out, device_tensor, to_2d
from repro_torch.kernels.ternary.ref import as_rows

#: level count of the 8-bit wire: 1 sign bit + 7 level bits = 2**7 - 1
QSGD8_LEVELS = 127


def qsgd8_levels_ref(g: torch.Tensor, param, seed, counter_base=0, *,
                     counter_map=None) -> torch.Tensor:
    """int8 signed stochastic levels of ``g`` (any shape, f32/bf16), shaped
    like ``g``. ``param`` is the decode scale max(||g||_2, eps) / 127 of the
    whole tensor (a scalar, or one value per row with per-row seeds, as
    ``ternary_compress_ref`` takes them); counters run over g's flat index
    from ``counter_base`` (a model rank's slice: ``counter_map``, as
    ``ternary_compress_ref`` takes it)."""
    rows, seeds = as_rows(g.to(torch.float32), seed)
    idx = counter_index(rows.shape[1], counter_base, g.device, counter_map)
    prm = torch.clamp(device_tensor(param, g).reshape(-1, 1), min=1e-20)
    r = torch.abs(rows) / prm
    low = torch.floor(r)
    u = prng.uniform01(seeds, idx)
    level = torch.minimum(low + (u < (r - low)).to(torch.float32),
                          torch.full((), float(QSGD8_LEVELS), device=g.device))
    sym = torch.sign(rows) * level
    sym = torch.where(torch.isnan(sym), torch.zeros((), device=g.device), sym)
    return sym.to(torch.int8).reshape(g.shape)


def qsgd8_pack8_ref(g: torch.Tensor, param, seed, counter_base=0, *,
                    counter_map=None) -> torch.Tensor:
    """(any shape) -> (rows, LANES) int8 canonical wire view: quantize, then
    pad to the canonical view, the two passes the fused kernel does in one."""
    view, _ = to_2d(qsgd8_levels_ref(g, param, seed, counter_base,
                                     counter_map=counter_map).reshape(-1))
    return view


def unpack8_sum_ref(gathered: torch.Tensor, scales: torch.Tensor, *, out=None,
                    accumulate: bool = False) -> torch.Tensor:
    """(M, rows, LANES) int8 worker levels + (M,) float32 scales -> (rows,
    LANES) float32 ``sum_m scales[m] * levels[m]``: a left-to-right loop in
    worker order from +0.0 (or, with ``accumulate``, from ``out``'s values;
    ``out`` takes the sum in place), each product and sum rounded on its
    own."""
    s = scales.to(torch.float32)
    acc = decode_sum_out(out, gathered.shape[1:], torch.float32, (torch.float32,), accumulate,
                         gathered.device)
    if not accumulate:
        acc.zero_()
    for i in range(gathered.shape[0]):
        acc += gathered[i].to(torch.float32) * s[i]
    return acc
