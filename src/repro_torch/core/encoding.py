"""Communication-bit accounting (paper §6, Eq. 12): the bit model ``run_fl``
reports, copied from ``repro.core.encoding``.

Sparse ternary streams are coded as Golomb-coded run lengths of the nonzero
positions plus one sign bit per nonzero (Sattler et al. 2019a):

    b_bar = b* + 1 / (1 - (1-p)^(2^b*))

with p the nonzero ratio. Sign costs 1 bit/coord; fp32 costs 32.
"""

from __future__ import annotations

import math

GOLDEN_RATIO = (math.sqrt(5.0) + 1.0) / 2.0


def golomb_bstar(p: float) -> int:
    """Optimal Golomb parameter b* = 1 + floor(log2(log(phi-1)/log(1-p)))."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"sparsity ratio p must be in (0,1), got {p}")
    num = math.log(GOLDEN_RATIO - 1.0)
    den = math.log1p(-p)  # log1p: at tiny p, log(1.0 - p) underflows to -0.0
    ratio = num / den
    if ratio <= 1.0:
        return 0
    return max(0, 1 + int(math.floor(math.log2(ratio))))


def golomb_bits_per_index(p: float) -> float:
    """Average bits per nonzero index, Eq. 12."""
    bstar = golomb_bstar(p)
    denom = -math.expm1((2.0 ** bstar) * math.log1p(-p))
    return bstar + 1.0 / denom


def ternary_stream_bits(d: int, nnz: int, *, coder: str = "golomb") -> float:
    """Uplink bits of one worker's d-dim ternary message with nnz nonzeros
    (golomb | dense | naive_index | packed2bit)."""
    if coder not in ("golomb", "dense", "naive_index", "packed2bit"):
        raise ValueError(f"unknown coder {coder!r}")
    if coder == "dense":
        return d * math.log2(3.0)
    if coder == "packed2bit":
        return d * 2.0
    if nnz <= 0:
        return 0.0
    p = min(max(nnz / d, 1e-12), 1.0 - 1e-12)
    if coder == "golomb":
        return nnz * (golomb_bits_per_index(p) + 1.0)
    return nnz * (math.log2(max(d, 2)) + 1.0)


def baseline_bits_per_round(d: int, algorithm: str, *, nnz: float | None = None) -> float:
    """Uplink bits per worker per round; the model is the spec's ``uplink_bits``."""
    from repro_torch.core.compressors import get_spec  # lazy: encoding has no deps

    try:
        model = get_spec(algorithm).uplink_bits
    except KeyError as e:
        raise ValueError(str(e)) from None
    if model == "dense_sign":
        return float(d)
    if model == "golomb_ternary":
        if nnz is None:
            raise ValueError("ternary methods need the realized nnz")
        return ternary_stream_bits(d, int(round(nnz)), coder="golomb") + 32.0
    if model == "fp32":
        return 32.0 * d
    return 8.0 * d + 32.0
