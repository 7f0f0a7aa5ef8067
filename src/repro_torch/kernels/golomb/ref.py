"""The Golomb/Rice entropy-coded ternary wire: the format definition and the
plain PyTorch versions, byte for byte ``repro.kernels.golomb.ref``.

Wire format of one worker message (one leaf, n true coordinates, plan-time
nonzero fraction p):

  * payload buffer: ``(rows, ROW_BYTES)`` uint8, ``rows = golomb_rows(n, p)``
    fixed when the step is built; flattened row-major it is the byte stream.
  * bytes 0-3: uint32 little-endian count of *shipped* nonzeros.
  * bytes 4-7: uint32 little-endian count of *dropped* nonzeros (capacity
    overflow). The header makes a gathered buffer self-describing.
  * bits from byte 8, LSB-first within each byte. Per shipped nonzero, in
    ascending flat-coordinate order, a Rice code of the zero-run gap
    (gap_0 = pos_0; gap_k = pos_k - pos_{k-1} - 1) with the static parameter
    b = ``rice_b(p)`` (Eq. 12's b*): ``gap >> b`` one-bits, a terminating
    zero bit, b remainder bits LSB-first, then 1 sign bit (1 = negative).

Capacity is static: a six-sigma bound on the nonzero count at the plan
fraction plus the worst-case unary spill. A denser message is truncated at
capacity (a suffix of its codes is dropped and counted in the header), and a
configuration whose capacity cannot beat the flat 2-bit wire fails when it is
built (``golomb_rows`` raises).

Bit offsets are 64-bit here and in the kernels. The JAX reference sums code
lengths in int32 (``emit_stream``), which wraps once a message's codes pass
2^31 bits; the two agree wherever the reference does not wrap.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.encoding import golomb_bstar
from repro_torch.kernels.common import LANES, canonical_rows

#: in-band header: two uint32 LE counters (shipped nonzeros, dropped nonzeros)
HEADER_BYTES = 8

#: bytes per payload row: the pack2 wire's 128-byte row
ROW_BYTES = LANES // 4


def rice_b(p: float) -> int:
    """The static Rice parameter: Eq. 12's b* at the plan fraction p."""
    return golomb_bstar(p)


def golomb_capacity_nnz(n: int, p: float) -> int:
    """Plan-time bound on the nonzeros one n-coordinate message may ship:
    mean + six sigma of Binomial(n, p), plus a small-n floor."""
    mean = n * p
    sdev = math.sqrt(n * p * (1.0 - p))
    return min(n, int(math.ceil(mean + 6.0 * sdev + 8.0)))


def golomb_capacity_bits(n: int, p: float) -> int:
    """Worst-case coded bits for a message of at most capacity_nnz nonzeros:
    2 + b bits a code, plus unary parts that sum to at most n / 2^b."""
    b = rice_b(p)
    cap = golomb_capacity_nnz(n, p)
    return cap * (2 + b) + int(math.ceil(n / float(1 << b)))


def golomb_rows(n: int, p: float) -> int:
    """Payload rows of one n-coordinate message at plan fraction p: the one
    capacity rule of the encoder's output shape and the wire's ledger. Raises
    when the capacity cannot beat the flat 2-bit wire."""
    cap_bytes = HEADER_BYTES + (golomb_capacity_bits(n, p) + 7) // 8
    rows = -(-cap_bytes // ROW_BYTES)
    pack2_bytes = canonical_rows(n) * ROW_BYTES
    if rows * ROW_BYTES >= pack2_bytes:
        raise ValueError(
            f"golomb wire capacity ({rows * ROW_BYTES} B) does not beat the "
            f"flat 2-bit wire ({pack2_bytes} B) for n={n} at nonzero fraction "
            f"p={p} — entropy coding loses above ~35% density. Use the pack2 "
            f"wire (e.g. compressor 'sparsign') for this regime.")
    return rows


def golomb_nbytes(n: int, p: float) -> int:
    """One worker's payload bytes for an n-coordinate leaf, capacity padding
    included."""
    return golomb_rows(n, p) * ROW_BYTES


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _le32(x: torch.Tensor) -> torch.Tensor:
    """int64 scalar tensor (a uint32 value) -> 4 little-endian uint8 bytes."""
    return torch.stack([(x >> (8 * i)) & 0xFF for i in range(4)]).to(torch.uint8)


def emit_stream(t_flat: torch.Tensor, *, b: int, rows: int) -> torch.Tensor:
    """Ternary flat stream -> (rows, ROW_BYTES) uint8 wire payload.

    Code offsets are the running sum of the nonzeros' code lengths (int64);
    codes that end past the capacity are dropped as a suffix and counted.
    Unary runs are written as +1/-1 marks and a running sum, remainder and
    sign bits by index, then the bits are packed LSB-first."""
    dev = t_flat.device
    n_bits = (rows * ROW_BYTES - HEADER_BYTES) * 8
    t = t_flat.reshape(-1)
    pos = torch.nonzero(t).reshape(-1)
    prev = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev), pos])[:-1]
    gap = pos - prev - 1
    q = gap >> b
    end = torch.cumsum(q + (2 + b), 0)
    off = end - (q + (2 + b))
    fits = end <= n_bits
    shipped = torch.sum(fits, dtype=torch.int64)
    dropped = pos.numel() - shipped
    off, q, gap, neg = off[fits], q[fits], gap[fits], (t[pos] < 0)[fits]
    mark = torch.zeros(n_bits + 1, dtype=torch.int8, device=dev)
    mark.index_put_((off,), torch.ones_like(off, dtype=torch.int8), accumulate=True)
    mark.index_put_((off + q,), torch.full_like(off, -1, dtype=torch.int8), accumulate=True)
    bit = torch.cumsum(mark, 0, dtype=torch.int8)[:n_bits].to(torch.uint8)
    base = off + q + 1
    for j in range(b):
        bit[base + j] = ((gap >> j) & 1).to(torch.uint8)
    bit[base + b] = neg.to(torch.uint8)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=dev))
    body = torch.sum(bit.reshape(-1, 8).to(torch.int32) * weights, dim=1).to(torch.uint8)
    return torch.cat([_le32(shipped), _le32(dropped), body]).reshape(rows, ROW_BYTES)


def golomb_encode_ref(t: torch.Tensor, *, p: float) -> torch.Tensor:
    """Ternary message (any shape) -> (golomb_rows(n, p), ROW_BYTES) uint8
    wire payload: the plain version of both encode kernels."""
    n = int(t.numel())
    return emit_stream(t.reshape(-1), b=rice_b(p), rows=golomb_rows(n, p))


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _header_count(stream: torch.Tensor, at: int) -> int:
    h = stream.reshape(-1)[at:at + 4].to(torch.int64)
    return int(h[0] | (h[1] << 8) | (h[2] << 16) | (h[3] << 24))


def _code_starts(bit: torch.Tensor, b: int, k: int):
    """Start bits of the stream's first k codes, and each bit's next zero
    bit. A code starting at i ends at next_zero(i) + 2 + b; the starts are
    the orbit of bit 0 under that map, found by pointer doubling (the map
    only moves forward, so ceil(log2(bits / (2 + b))) + 1 rounds reach every
    code). Bits past the buffer read as 0."""
    nb = bit.numel()
    dev = bit.device
    sink = torch.full((), nb, dtype=torch.int64, device=dev)
    idx = torch.arange(nb, dtype=torch.int64, device=dev)
    zeros_at = torch.where(bit == 0, idx, sink)
    del idx
    next_zero = torch.flip(torch.cummin(torch.flip(zeros_at, (0,)), 0).values, (0,))
    del zeros_at
    # one slot past the end maps to itself
    jump = torch.cat([torch.clamp(next_zero + (2 + b), max=nb), sink.reshape(1)])
    reach = torch.zeros(nb + 1, dtype=torch.bool, device=dev)
    reach[0] = True
    for _ in range(max(1, math.ceil(math.log2(max(nb / (2 + b), 1)))) + 1):
        reach[jump[reach]] = True
        jump = jump[jump]
    return torch.nonzero(reach[:nb]).reshape(-1)[:k], next_zero


def decode_stream(stream: torch.Tensor, n: int, *, b: int) -> torch.Tensor:
    """One worker's payload -> int32 ternary votes, flat (n,): the header's
    shipped count of codes, each a unary quotient, b remainder bits and a
    sign bit; positions >= n are dropped. An all-zero buffer (a masked-out
    worker) decodes to zero votes."""
    flat = stream.reshape(-1)
    dev = flat.device
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    k = _header_count(flat, 0)
    if k == 0:
        return out
    body = flat[HEADER_BYTES:].to(torch.int32)
    bit = ((body[:, None] >> torch.arange(8, dtype=torch.int32, device=dev)) & 1)
    bit = bit.to(torch.uint8).reshape(-1)
    starts, next_zero = _code_starts(bit, b, k)
    z = next_zero[starts]
    del next_zero
    padded = torch.cat([bit, torch.zeros(b + 2, dtype=torch.uint8, device=dev)])
    rem = torch.zeros_like(starts)
    for j in range(b):
        rem |= padded[z + 1 + j].to(torch.int64) << j
    gap = ((z - starts) << b) | rem
    sign = padded[z + 1 + b].to(torch.int32)
    pos = torch.cumsum(gap + 1, 0) - 1
    keep = pos < n
    out.index_put_((pos[keep],), (1 - 2 * sign)[keep], accumulate=True)
    return out


def golomb_decode_ref(stream: torch.Tensor, n: int, shape, *, p: float) -> torch.Tensor:
    """One worker's payload -> its int8 ternary message in ``shape``."""
    return decode_stream(stream, n, b=rice_b(p)).to(torch.int8).reshape(shape)


def decode_sum_workers(gathered: torch.Tensor, n: int, *, b: int) -> torch.Tensor:
    """(M, rows, ROW_BYTES) gathered payloads -> int32 vote sum, flat (n,),
    workers added in gather order."""
    total = torch.zeros(n, dtype=torch.int32, device=gathered.device)
    for w in range(int(gathered.shape[0])):
        total = total + decode_stream(gathered[w], n, b=b)
    return total


def ungolomb_sum_ref(gathered: torch.Tensor, n: int, shape, *, p: float) -> torch.Tensor:
    """Plain decode-sum: gathered payloads -> int32 vote sum in ``shape``."""
    return decode_sum_workers(gathered, n, b=rice_b(p)).reshape(shape)


def decode_wsum_workers(gathered: torch.Tensor, weights: torch.Tensor, n: int,
                        *, b: int) -> torch.Tensor:
    """(M, rows, ROW_BYTES) payloads + (M,) float32 weights -> float32
    ``sum_m w_m * votes_m``, flat (n,): accumulated from +0.0 in worker order,
    each product and sum rounded on its own."""
    w = weights.to(torch.float32).reshape(-1)
    total = torch.zeros(n, dtype=torch.float32, device=gathered.device)
    for m in range(int(gathered.shape[0])):
        total = total + decode_stream(gathered[m], n, b=b).to(torch.float32) * w[m]
    return total


def ungolomb_wsum_ref(gathered: torch.Tensor, weights: torch.Tensor, n: int, shape,
                      *, p: float) -> torch.Tensor:
    """Plain weighted decode-sum in ``shape``."""
    return decode_wsum_workers(gathered, weights, n, b=rice_b(p)).reshape(shape)
