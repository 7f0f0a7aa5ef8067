"""Plain PyTorch versions of the 2-bit packed vote wire, bit for bit
``repro.kernels.pack2bit.ref``.

Wire format: block-interleaved packing over the canonical (rows, LANES) view.
Byte j of a row packs the symbols at columns (j, j + L/4, j + 2L/4, j + 3L/4)
in bits 0-1, 2-3, 4-5, 6-7. Codes: 0 -> 00, +1 -> 01, -1 -> 10; code 11
decodes as 0.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import decode_sum_out, encode2bit

#: output dtypes of the vote sum: the wire's ``_sum_dtype(M)`` and JAX's int32
SUM_DTYPES = (torch.int8, torch.int16, torch.int32)


def _decode(c: torch.Tensor) -> torch.Tensor:
    """2-bit code -> ternary int8; code 3 (never written) decodes as 0."""
    one = torch.ones((), dtype=torch.int8, device=c.device)
    return torch.where(c == 1, one, torch.where(c == 2, -one, torch.zeros_like(one)))


def pack2bit_ref(t2d: torch.Tensor) -> torch.Tensor:
    """(rows, L) int8 ternary -> (rows, L // 4) uint8."""
    q = t2d.shape[1] // 4
    c = [encode2bit(t2d[:, k * q:(k + 1) * q]) for k in range(4)]
    return c[0] | (c[1] << 2) | (c[2] << 4) | (c[3] << 6)


def unpack2bit_ref(p2d: torch.Tensor) -> torch.Tensor:
    """(rows, L // 4) uint8 -> (rows, L) int8 ternary."""
    return torch.cat([_decode((p2d >> (2 * k)) & 3) for k in range(4)], dim=1)


def unpack2bit_sum_ref(gathered: torch.Tensor, *, out=None,
                       accumulate: bool = False) -> torch.Tensor:
    """(M, rows, L // 4) packed worker votes -> (rows, L) int32 vote sum.
    The oracle decodes every message and sums (one message at a time, so an
    int8 copy of one message, not of all M, is alive at once). With ``out``
    (rows x L elements of a ``SUM_DTYPES`` dtype) the sum is written there in
    that dtype's wrapping arithmetic, or, with ``accumulate``, added to what
    it holds."""
    m, rows, q = gathered.shape
    acc = decode_sum_out(out, (rows, 4 * q), torch.int32, SUM_DTYPES, accumulate,
                         gathered.device)
    if not accumulate:
        acc.zero_()
    for i in range(m):
        acc += unpack2bit_ref(gathered[i]).to(acc.dtype)
    return acc


def unpack2bit_wsum_ref(gathered: torch.Tensor, weights: torch.Tensor, *, out=None,
                        accumulate: bool = False) -> torch.Tensor:
    """(M, rows, L // 4) packed worker votes + (M,) float32 weights -> (rows,
    L) float32 ``sum_m weights[m] * votes_m``, accumulated from +0.0 (or,
    with ``accumulate``, from ``out``'s values) strictly in worker order,
    each product and sum rounded on its own."""
    m, rows, q = gathered.shape
    w = weights.to(torch.float32)
    acc = decode_sum_out(out, (rows, 4 * q), torch.float32, (torch.float32,), accumulate,
                         gathered.device)
    if not accumulate:
        acc.zero_()
    for i in range(m):
        acc += unpack2bit_ref(gathered[i]).to(torch.float32) * w[i]
    return acc
