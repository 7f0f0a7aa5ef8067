"""The arithmetic that qsgd8_pack8's Hopper kernel (``csrc/pack8.cu``) rests
on, held on the CPU where the kernel cannot run: its steps emulated in numpy,
instruction for instruction, against the plain float formula and against
both plain versions (the JAX package's and the port's):

- the level in integers: ``(min(ceil(r 2^24), 127 2^24) + 2^24 - 1 - k) >> 24``
  == ``min(floor(r) + [k 2^-24 < r - floor(r)], 127)``, NaN to 0, for every
  bf16 bit pattern at scales from below the 1e-20 floor to FLT_MAX, at
  u = 0, u = 1 - 2^-24 and drawn u;
- the hoisted division (``q0 = RN(a y)`` and two fma corrections with
  ``y = RN(1/d)``, ``d = pm 2^-24``) == ``RN(a / d)``, on pairs on either
  side of rounding midpoints and on tiny quotients, with every fma rounded
  once (``fma32``, checked against exact rationals);
- the byte-wise sign, and the complemented top 24 bits of the counter hash,
  equal to ``repro_torch.core.prng.uniform01`` at counter bases that wrap
  past 2^32.

The kernel itself is held against the plain version on the card, bit for
bit, by ``chip_smoke.py`` (every bf16 and every float32 bit pattern) and
``tests/test_torch_cuda.py``."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prng as jprng   # first: the JAX package's own import order
from repro.kernels.pack8.ref import qsgd8_levels_ref as j_levels_ref
from repro_torch.core import prng
from repro_torch.kernels.pack8.ref import qsgd8_levels_ref

F32, F64 = np.float32, np.float64
M32 = np.uint64(0xFFFFFFFF)
TOP = 127 << 24
EVERY_BF16 = (np.arange(1 << 16, dtype=np.uint32) << np.uint32(16)).view(F32)


def bits_f32(b) -> F32:
    return np.array([b], np.uint32).view(F32)[0]


def fma32(x, y, z) -> np.ndarray:
    """float32 fma(x, y, z), rounded once: x y is exact in float64, TwoSum
    makes s + err == x y + z exactly, and s's float32 rounding is wrong only
    where s is a float32 midpoint, which err's sign then breaks."""
    x, y, z = (np.asarray(v, F32) for v in (x, y, z))
    p, z64 = x.astype(F64) * y.astype(F64), z.astype(F64)
    with np.errstate(over="ignore", invalid="ignore"):
        s = p + z64
        bb = s - p
        err = (p - (s - bb)) + (z64 - bb)
        r = s.astype(F32)
        up, dn = np.nextafter(r, F32(np.inf)), np.nextafter(r, F32(-np.inf))
        # s is a midpoint between r and one neighbour: err says which side
        mid_up = s == (r.astype(F64) + up.astype(F64)) / 2
        mid_dn = s == (r.astype(F64) + dn.astype(F64)) / 2
        return np.where(mid_up & (err > 0), up, np.where(mid_dn & (err < 0), dn, r))


def rn32(v: Fraction) -> float:
    """v rounded to float32, to nearest even, exactly (subnormals, overflow)."""
    if v == 0:
        return 0.0
    sign, v = (-1 if v < 0 else 1), abs(v)
    e = max(v.numerator.bit_length() - v.denominator.bit_length(), -126)
    while Fraction(2) ** e > v:
        e -= 1
    while Fraction(2) ** (e + 1) <= v:
        e += 1
    e = max(e, -126)
    m = v / Fraction(2) ** (e - 23)
    q, rem = divmod(m.numerator, m.denominator)
    if 2 * rem > m.denominator or (2 * rem == m.denominator and q % 2):
        q += 1
    out = Fraction(q) * Fraction(2) ** (e - 23)
    return sign * (float("inf") if out >= 2**128 else float(out))


def test_fma32_is_rounded_once():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(3000), [1 + 2**-23, 3.0, 2**-149, 1e-30, 2**100]]).astype(F32)
    y = np.concatenate([rng.randn(3000), [1 - 2**-23, 1 / 3, 0.5, 1e-10, 2**27]]).astype(F32)
    z = np.concatenate([rng.randn(3000) * 10.0 ** rng.randint(-30, 5, 3000),
                        [-1.0, -1.0, 2**-149, -1e-40, -(2.0**127)]]).astype(F32)
    # products that cancel their addend to a few bits, and ties of the sum
    z[:500] = -(x[:500].astype(F64) * y[:500].astype(F64)).astype(F32)
    z[500:1000] = (-(x[500:1000].astype(F64) * y[500:1000].astype(F64))
                   + np.ldexp(1.0, np.frexp(x[500:1000] * y[500:1000])[1] - 25)).astype(F32)
    got = fma32(x, y, z)
    want = np.array([rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
                     for a, b, c in zip(x, y, z)], F32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def hash_complement(seed: int, counters: np.ndarray) -> np.ndarray:
    """common.cuh's uniform_complement: 2^24 - 1 - k from the folded seed
    hash and the counter times the golden ratio."""
    s = np.uint64((int(seed) + prng.GOLDEN) & 0xFFFFFFFF)
    for shift, mul in ((16, prng.C1), (13, prng.C2), (16, None)):
        s ^= s >> np.uint64(shift)
        if mul:
            s = (s * np.uint64(mul)) & M32
    folded = s ^ (s >> np.uint64(16))
    a = (counters.astype(np.uint64) * np.uint64(prng.GOLDEN)) & M32
    x = a ^ (a >> np.uint64(16)) ^ folded
    x = (x * np.uint64(prng.C1)) & M32
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(prng.C2)) & M32
    return (~(x ^ (x >> np.uint64(16))) & M32) >> np.uint64(8)


def message_constants(param) -> dict:
    """Qsgd8State::make: pm = max(param, 1e-20) keeping NaN; the hoisted
    division's d, y = RN(1/d) (the float64 quotient rounds to float32 once
    more without a double-rounding error: 1/d is never within 2^-49 of its
    own value from a float32 midpoint) and cap = 128 pm."""
    p = F32(param)
    pm = p if np.isnan(p) else max(p, F32(1e-20))
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        d = F32(pm * F32(2.0**-24))
        return {"pm": pm, "d": d, "y": F32(1.0 / F64(d)), "cap": F32(pm * F32(128.0)),
                "hoisted": bool(pm < 2)}


def hoisted_quotient(a: np.ndarray, d, y) -> np.ndarray:
    """pack8.cu's q0 = RN(a y), q1 = RN(q0 + RN(a - q0 d) y), Q = RN(q1 + (a - q1 d) y)."""
    with np.errstate(over="ignore", invalid="ignore"):
        q0 = (a * y).astype(F32)
    q1 = fma32(fma32(-q0, d, a), y, q0)
    return fma32(fma32(-q1, d, a), y, q1)


def scaled_ceil(x: np.ndarray, c: dict) -> np.ndarray:
    """min(ceil(2^24 r), 127 2^24) as pack8.cu's scaled_ceil computes it."""
    ax = np.abs(x)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        if c["hoisted"]:
            a = np.where(np.isnan(ax), ax, np.minimum(ax, c["cap"]))   # min.NaN
            q = hoisted_quotient(a, c["d"], c["y"])
        else:
            q = (ax / c["pm"]).astype(F32) * F32(2.0**24)
        cvt = np.clip(np.ceil(q.astype(F64)), 0, 2.0**32 - 1)      # cvt.rpi.u32: saturates
    cvt = np.where(np.isnan(q), 0, cvt).astype(np.uint64)           # and takes NaN to 0
    return np.minimum(cvt, np.uint64(TOP))


def signed_levels(lv: np.ndarray, neg: np.ndarray) -> np.ndarray:
    """pack8.cu's signed_levels on uint32 words of four bytes."""
    lv, neg = lv.astype(np.uint64), neg.astype(np.uint64)
    lo7, hi = np.uint64(0x7F7F7F7F), np.uint64(0x80808080)
    return (((lo7 ^ neg) - (lv ^ (~neg & lo7))) & M32) ^ (neg & hi)


def kernel_levels(x: np.ndarray, param, comp: np.ndarray) -> np.ndarray:
    """int8 levels of float32 values x as pack8.cu computes them, given each
    coordinate's 2^24 - 1 - k: the top byte of the sum, four to a word, the
    sign applied to the word."""
    top = (scaled_ceil(x, message_constants(param)) + comp.astype(np.uint64)) >> np.uint64(24)
    pad = -x.size % 4
    lv = np.concatenate([top, np.zeros(pad, np.uint64)]).reshape(-1, 4)
    neg = np.concatenate([np.signbit(x), np.zeros(pad, bool)]).reshape(-1, 4)
    shift = np.uint64(8) * np.arange(4, dtype=np.uint64)
    words = signed_levels((lv << shift).sum(1), (neg.astype(np.uint64) * 0xFF << shift).sum(1))
    out = (words[:, None] >> shift) & np.uint64(0xFF)
    return out.astype(np.uint8).view(np.int8).reshape(-1)[:x.size]


def plain_levels(x: np.ndarray, param, u: np.ndarray) -> np.ndarray:
    """The plain versions' float formula (kernels/pack8/ref.py) with u given."""
    g = torch.from_numpy(x)
    prm = torch.clamp(torch.tensor(param, dtype=torch.float32), min=1e-20)
    r = torch.abs(g) / prm
    low = torch.floor(r)
    level = torch.minimum(low + (torch.from_numpy(u) < (r - low)).to(torch.float32),
                          torch.tensor(127.0))
    sym = torch.sign(g) * level
    sym = torch.where(torch.isnan(sym), torch.zeros(()), sym)
    return sym.to(torch.int8).numpy()


def around(x: float) -> list:
    v = F32(x)
    with np.errstate(over="ignore"):
        return [np.nextafter(v, F32(-np.inf)), v, np.nextafter(v, F32(np.inf))]


# NaN, +-inf, 0 and below the 1e-20 floor; the floor, 1, the hoisted
# division's limit 2 and FLT_MAX with their neighbours; a mantissa of all
# ones; powers of two +- an ulp; trainer-like scales; __fdiv_rn's side (>= 2)
SCALES = ([np.nan, np.inf, -np.inf, 0.0, -1.0, 1e-45, 1e-30, bits_f32(0x3FFFFFFF),
           bits_f32(0x3F7FFFFF), 3.0, 1e3, 0.026, 7.3e-3, 1.7e-4]
          + around(1e-20) + around(1.0) + around(2.0) + around(bits_f32(0x7F7FFFFF))[:2]
          + [v for k in (-66, -40, -24, -12, -1, 23, 100, 126) for v in around(2.0**k)])


@pytest.mark.parametrize("group", range(4))
def test_level_arithmetic_every_bf16_pattern(group):
    """Every bf16 bit pattern at each scale of the group, at u = 0,
    u = 1 - 2^-24 and drawn u: the kernel's integer level and byte-wise
    sign == the plain float formula."""
    rng = np.random.RandomState(group)
    for param in SCALES[group::4]:
        c = scaled_ceil(EVERY_BF16, message_constants(param))   # once a scale
        for k in (np.zeros(1 << 16, np.int64), np.full(1 << 16, 2**24 - 1),
                  rng.randint(0, 2**24, 1 << 16)):
            u = (k * 2.0**-24).astype(F32)
            comp = (2**24 - 1 - k).astype(np.uint64)
            top = (c + comp) >> np.uint64(24)
            assert top.max() <= 127
            want = plain_levels(EVERY_BF16, param, u)
            got = kernel_levels(EVERY_BF16, param, comp)
            np.testing.assert_array_equal(got, want, err_msg=f"scale {param!r}")


@pytest.mark.parametrize("counter_base", [0, 2**32 - 7, 2**32 - 40000])
def test_kernel_stream_equals_jax_and_port_refs(counter_base):
    """The emulated kernel, drawing from the counter hash over every bf16
    bit pattern (counters wrapping past 2^32), == the port's
    qsgd8_levels_ref and the JAX package's. XLA on the CPU flushes
    subnormals, which moves a level only where u = 0 meets r < 2^-24: those
    coordinates are held against the port's version alone."""
    g = torch.from_numpy(EVERY_BF16).to(torch.bfloat16)
    counters = (np.arange(1 << 16, dtype=np.uint64) + np.uint64(counter_base)) & M32
    for i, param in enumerate((1e-20, 0.026, 1.0, bits_f32(0x3FFFFFFF), 3.0, 2.0**-60)):
        seed = 0xC0FFEE + 977 * i
        comp = hash_complement(seed, counters)
        got = kernel_levels(EVERY_BF16, param, comp)
        np.testing.assert_array_equal(got, qsgd8_levels_ref(g, param, seed, counter_base).numpy())
        jax_l = np.asarray(j_levels_ref(jnp.asarray(EVERY_BF16), param, seed, counter_base))
        pm = max(F32(param), F32(1e-20))
        with np.errstate(over="ignore", invalid="ignore"):
            flushed = (comp == 2**24 - 1) & (np.abs(EVERY_BF16) / pm < 2.0**-24)
        np.testing.assert_array_equal(got[~flushed], jax_l[~flushed])


@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B9, 0xFFFFFFFF])
def test_uniform_complement_is_prng_uniform01(seed):
    """2^24 - 1 - k, with u = k 2^-24 the stream of prng.uniform01 (the
    port's and the JAX package's), at counters at and past 2^32 (uint32,
    wrapping)."""
    counters = np.concatenate([np.arange(2**32 - 3000, 2**32 + 3000, dtype=np.uint64),
                               np.random.RandomState(seed & 0xFFFF).randint(
                                   0, 2**32, 1 << 14, dtype=np.uint64)]) & M32
    u = prng.uniform01(seed, torch.from_numpy(counters.astype(np.int64))).numpy()
    np.testing.assert_array_equal(u, np.asarray(jprng.uniform01(seed, jnp.asarray(
        counters.astype(np.uint32)))))
    k = (u.astype(F64) * 2**24).astype(np.uint64)
    np.testing.assert_array_equal(hash_complement(seed, counters), np.uint64(2**24 - 1) - k)


def near_midpoints(rng, count: int, big: bool) -> tuple:
    """(a, d): float32 pairs whose quotient a / d is N U / (2 B) from a
    rounding midpoint, N = +-1 or +-3, where U is its ulp and B d's 24-bit
    significand (odd; near 2^24 when big): the nearest a quotient of 24-bit
    operands comes to a midpoint. A 2^s - N = (2M + 1) B is solved for A
    with 2^s's inverse mod B (s = 24 for a quotient in [1, 2), 25 in
    [1/2, 1)); then both are scaled so that d spans [2^-91, 1] and the
    quotient [2^-11, 2^31]."""
    bsig = (2**24 - 1 - 2 * rng.randint(0, 2048, count) if big
            else 2 * rng.randint(2**22, 2**23, count) + 1)
    pairs = []
    for bs, n, s in zip(bsig.tolist(), rng.choice([-3, -1, 1, 3], count).tolist(),
                        rng.randint(24, 26, count).tolist()):
        asig = n * pow(2**s, -1, bs) % bs
        while asig < 2**23:
            asig += bs
        if asig < 2**24 and (asig >= bs) == (s == 24) and (asig * 2**s - n) // bs % 2:
            pairs.append((asig, bs))
    asig, bsig = np.array(pairs, F64).T
    ed = rng.randint(-91, 1, asig.size)
    ez = rng.randint(-11, 31, asig.size)
    return ((asig * 2.0 ** (ed + ez - 23)).astype(F32), (bsig * 2.0 ** (ed - 23)).astype(F32))


@pytest.mark.parametrize("big", [False, True])
def test_hoisted_division_is_correctly_rounded(big):
    """Q == RN(a / d) for quotients as near a rounding midpoint as 24-bit
    operands come, and for drawn pairs (the float64 quotient rounds to
    float32 once more without error: a / d is never within 2^-49 of itself
    from a float32 midpoint)."""
    rng = np.random.RandomState(int(big))
    a, d = near_midpoints(rng, 1 << 14, big)
    assert a.size > 3000
    rnd_a = (rng.rand(1 << 16) * 2.0 ** rng.randint(-100, 30, 1 << 16)).astype(F32)
    rnd_d = (rng.rand(1 << 16) * 2.0 ** rng.randint(-90, 0, 1 << 16) + 2.0**-90).astype(F32)
    a, d = np.concatenate([a, rnd_a]), np.concatenate([d, rnd_d])
    z = a.astype(F64) / d.astype(F64)
    keep = (z >= 2.0**-11) & (z <= 2.0**31)             # the exact-remainder regime
    a, d, z = a[keep], d[keep], z[keep]
    y = (1.0 / d.astype(F64)).astype(F32)
    np.testing.assert_array_equal(hoisted_quotient(a, d, y).view(np.uint32),
                                  z.astype(F32).view(np.uint32))


@pytest.mark.parametrize("param", [1e-20, 1e-3, 1.0, bits_f32(0x3FFFFFFF)])
def test_tiny_quotients_give_one_exactly_for_nonzero_input(param):
    """Below z = a / d = 2^-11, ceil(2^24 RN(a / pm)) is 1 exactly when
    a > 0 (pm < 2), and so is the hoisted path's ceil(Q): subnormal and
    tiny normal gradients, and zeros."""
    x = np.concatenate([np.arange(0, 1 << 12, dtype=np.uint32),            # +0 and subnormals
                        np.arange(0x007FF000, 0x00801000, dtype=np.uint32),
                        np.random.RandomState(4).randint(0, 0x30000000, 1 << 14)
                        .astype(np.uint32)]).view(F32)
    c = message_constants(param)
    pm = c["pm"]
    x = x[np.abs(x).astype(F64) / F64(pm) * 2**24 < 2.0**-11]
    assert x.size > 4000
    got = scaled_ceil(x, c)
    want = np.array([0 if v == 0 else 1 for v in x], np.uint64)
    np.testing.assert_array_equal(got, want)
    plain = np.clip(np.ceil(((np.abs(x) / pm).astype(F32) * F32(2.0**24)).astype(F64)), 0, None)
    np.testing.assert_array_equal(plain.astype(np.uint64), want)


def test_signed_levels_every_byte():
    """Each byte position, every level 0..127 with either sign, beside drawn
    neighbours: no borrow crosses a byte; -0 stays 0."""
    rng = np.random.RandomState(5)
    lv = rng.randint(0, 128, (256 * 4, 4)).astype(np.uint64)
    neg = rng.randint(0, 2, (256 * 4, 4)).astype(np.uint64)
    for pos in range(4):
        rows = slice(256 * pos, 256 * (pos + 1))
        lv[rows, pos] = np.arange(256) % 128
        neg[rows, pos] = np.arange(256) // 128
    shift = np.uint64(8) * np.arange(4, dtype=np.uint64)
    words = signed_levels((lv << shift).sum(1), (neg * 0xFF << shift).sum(1))
    got = ((words[:, None] >> shift) & np.uint64(0xFF)).astype(np.uint8).view(np.int8)
    want = np.where(neg == 1, -lv.astype(np.int64), lv.astype(np.int64)).astype(np.int8)
    np.testing.assert_array_equal(got, want)
