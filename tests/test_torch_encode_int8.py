"""The int8 encoder's exact fast paths (``csrc/pack2_encode.cuh``, rows 1, 4
and 5) on the CPU, and the plain versions of rows 1 and 4 against JAX.

The kernels' two fast paths decide a coordinate from cheap arithmetic where
a proven bound settles it and fall back to the plain version's arithmetic
elsewhere. ``stochastic_decision`` and ``noisy_decision`` mirror their
float32 arithmetic step by step (``fma_f32``: a float32 fused multiply-add,
exactly rounded to nearest, down or up), and the tests hold every decision
they make against the exact comparison, on random values and on inputs built
to sit at the edge of the fallback band. The card runs the kernels
themselves (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sparsign.ref import sparsign_ref as j_sparsign_ref
from repro.kernels.ternary.ref import ternary_compress_ref as j_ternary_ref
from repro_torch.kernels.sparsign.ref import sparsign_ref
from repro_torch.kernels.ternary.ref import ternary_compress_ref

HEADER = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" /
          "pack2_encode.cuh").read_text()
#: the kernel's constants, read from the header it is compiled from
NOISE_DELTA = np.float32(re.search(r"kNoiseDelta = ([0-9.e+-]+)f;", HEADER).group(1))
BAND_LO, BAND_HI, BAND_TINY = np.float32(1 - 2.0**-21), np.float32(1 + 2.0**-21), 2.0**-126
EPS = np.float32(1e-12)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_header_holds_the_mirrored_constants():
    for text in ("kBandLo = 1.0f - 0x1p-21f", "kBandHi = 1.0f + 0x1p-21f",
                 "kBandTiny = 0x1p-126f", "fabsf(param) < 0x1p100f", "scale < 0x1p126f",
                 "__fmaf_rd(ah, ch, -kNoiseDelta)", "__fmaf_ru(ah, ch, kNoiseDelta)",
                 "__fmaf_rn(q, kBandLo, -kBandTiny)", "__fmaf_rn(q, kBandHi, kBandTiny)"):
        assert text in HEADER, text


# ------------------------------------------------------------ float32 mirrors

def f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c, mode: str = "rn") -> torch.Tensor:
    """float32 a * b + c rounded once: to nearest even ("rn"), down ("rd")
    or up ("ru"), as __fmaf_rn, __fmaf_rd and __fmaf_ru give it. a * b is
    exact in float64 (48 bits); the sum's float64 rounding error e comes
    from TwoSum, so the exact value is s + e, and only where s is itself a
    float32 midpoint (or e decides a directed rounding) does e change the
    float32 result."""
    c = torch.broadcast_to(torch.as_tensor(c, dtype=torch.float32), a.shape)
    p, c64 = a.double() * b.double(), c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    f = s.float()
    near = torch.nextafter(f, torch.where(f.double() < s, torch.full_like(f, np.inf),
                                          torch.full_like(f, -np.inf)))
    mid = (f.double() != s) & ((f.double() + near.double()) / 2 == s)
    f = torch.where(mid & (e != 0) & ((near.double() > s) == (e > 0)), near, f)
    if mode == "rn":
        return f
    above = (f.double() > s) | ((f.double() == s) & (e < 0))
    below = (f.double() < s) | ((f.double() == s) & (e > 0))
    if mode == "rd":
        return torch.where(above, torch.nextafter(f, torch.full_like(f, -np.inf)), f)
    return torch.where(below, torch.nextafter(f, torch.full_like(f, np.inf)), f)


def stochastic_decision(x: torch.Tensor, param, u: torch.Tensor):
    """StochasticTernaryRule's fast path: (keep, drop) where it decides,
    neither where the kernel takes __fdiv_rn."""
    param = torch.as_tensor(param, dtype=torch.float32)
    scale = torch.where(torch.isnan(param), param, torch.clamp(param, min=float(EPS)))
    recip = torch.ones((), dtype=torch.float32) / scale
    fast = scale < 2.0**126
    q = x.abs() * recip
    keep = u < fma_f32(q, torch.full_like(q, BAND_LO), -BAND_TINY)
    drop = ~(u < fma_f32(q, torch.full_like(q, BAND_HI), BAND_TINY)) & ~keep
    return keep & fast, drop & fast


def stochastic_exact_keep(x: torch.Tensor, param, u: torch.Tensor) -> torch.Tensor:
    param = torch.as_tensor(param, dtype=torch.float32)
    scale = torch.where(torch.isnan(param), param, torch.clamp(param, min=float(EPS)))
    return u < x.abs() / scale


def noisy_decision(x: torch.Tensor, sigma, ah: torch.Tensor, ch: torch.Tensor):
    """NoisySignRule's fast path: (+1, -1) where it decides the symbol of
    x + sigma n from Â and Ĉ, neither where the kernel takes logf, cosf and
    sqrtf."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    lo = fma_f32(ah, ch, -NOISE_DELTA, "rd")
    hi = fma_f32(ah, ch, NOISE_DELTA, "ru")
    y1, y2 = x + sigma * lo, x + sigma * hi
    fast = sigma.abs() < 2.0**100
    return (y1 > 0) & (y2 > 0) & fast, (y1 < 0) & (y2 < 0) & fast


def noisy_exact_symbol(x: torch.Tensor, sigma, n: torch.Tensor) -> torch.Tensor:
    y = x + torch.as_tensor(sigma, dtype=torch.float32) * n
    return torch.where(y > 0, 1, torch.where(y < 0, -1, 0))


# ------------------------------------------------------------ the mirrors' arithmetic

@pytest.mark.parametrize("mode", ["rn", "rd", "ru"])
def test_fma_f32_is_exactly_rounded(mode):
    """fma_f32 against exact rational arithmetic on values whose sums land on
    float32 midpoints, ties and subnormals."""
    from fractions import Fraction
    rng = np.random.RandomState(1)
    a = np.concatenate([rng.randn(200), [1 + 2.0**-23, 1.5, 3.0, 2.0**-70]]).astype(np.float32)
    b = np.concatenate([rng.randn(200), [1 - 2.0**-23, 1 + 2.0**-24 * 2, 2.0**-60, 2.0**-70]])
    b = b.astype(np.float32)
    c = np.concatenate([rng.randn(200) * 1e-7, [-2.0**-126, 2.0**-25, -1e-30, 2.0**-140]])
    c = c.astype(np.float32)
    got = fma_f32(f32(a), f32(b), f32(c), mode).numpy()
    for ai, bi, ci, gi in zip(a, b, c, got):
        exact = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        lo = np.nextafter(gi, np.float32(-np.inf))
        hi = np.nextafter(gi, np.float32(np.inf))
        if mode == "rd":
            assert Fraction(float(gi)) <= exact < Fraction(float(hi))
        elif mode == "ru":
            assert Fraction(float(lo)) < exact <= Fraction(float(gi))
        else:
            d = abs(Fraction(float(gi)) - exact)
            assert d <= abs(Fraction(float(lo)) - exact) and d <= abs(Fraction(float(hi)) - exact)


# ------------------------------------------------------------ stochastic_ternary

def stochastic_inputs(seed: int):
    """Gradients of every magnitude, subnormals, +-0, +-inf and NaN among
    them, each with uniforms on the 2^-24 grid at q = |x| / s's grid point
    and one either side, and at random."""
    rng = np.random.RandomState(seed)
    n = 4000
    x = (rng.randn(n) * 10.0 ** rng.uniform(-6, 1, n)).astype(np.float32)
    x[:16] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45, -1e-45, 2e-38, 1.17e-38, -3e-39,
              1e-30, 1.0, 0.5, 2.0**-24, 2.0**-25, 3 * 2.0**-26]
    return x


@pytest.mark.parametrize("param", [0.37, 1e-12, 0.0, 3e-13, 2.0**125, 2.0**126, np.nan, np.inf,
                                   7.25, 1e-3])
def test_stochastic_decision_agrees_with_the_exact_comparison(param):
    x = f32(stochastic_inputs(7))
    p32 = np.float32(param)
    scale = np.float32(np.nan) if np.isnan(p32) else max(p32, EPS)
    with np.errstate(invalid="ignore"):
        q = np.abs(x.numpy()) / scale   # float32, as torch computes it
    k0 = np.floor(np.nan_to_num(q, nan=0.0, posinf=1.0).clip(0, 1) * 2.0**24)
    ks = np.concatenate([k0 + d for d in (-1, 0, 1, 2)] +
                        [np.random.RandomState(8).randint(0, 2**24, x.numel())])
    u = f32((np.clip(ks, 0, 2**24 - 1) * 2.0**-24).astype(np.float32))
    xs = x.repeat(5)
    keep, drop = stochastic_decision(xs, param, u)
    exact = stochastic_exact_keep(xs, param, u)
    assert not bool((keep & ~exact).any()) and not bool((drop & exact).any())
    assert not bool((keep & drop).any())
    # the band is tight: every random draw decides where the fast path runs
    decided = (keep | drop)[4 * x.numel():].float().mean()
    assert decided > 0.999 if scale < 2.0**126 else decided == 0


def test_stochastic_band_is_rarely_hit_on_random_draws():
    """On N(0, 1) gradients with s = max |g| (TernGrad) and uniform draws,
    under 1e-5 of the coordinates fall back (the count seen is printed)."""
    rng = np.random.RandomState(9)
    x = f32(rng.randn(1 << 20))
    u = f32((rng.randint(0, 2**24, 1 << 20) * 2.0**-24).astype(np.float32))
    keep, drop = stochastic_decision(x, float(x.abs().max()), u)
    back = int((~(keep | drop)).sum())
    print(f"stochastic_ternary: {back} of {x.numel()} fall back")
    assert back <= 1e-5 * x.numel()
    assert torch.equal(keep, stochastic_exact_keep(x, float(x.abs().max()), u))


# ------------------------------------------------------------ noisy_sign

def noisy_inputs(seed: int, sigma: float):
    """Noise values n, factors Â, Ĉ whose product lies within delta of n
    (at random, and at both ends of the band), and gradients at -sigma n
    and a few ulps from it, so that x + sigma n sits on or near 0."""
    rng = np.random.RandomState(seed)
    m = 3000
    ah = f32(rng.uniform(0, 7.5, m))
    ch = f32(rng.uniform(-1, 1, m))
    ah[:4], ch[:4] = f32([0.0, 7.4338, 1.0, 3.0]), f32([1.0, -1.0, 0.0, 2.0**-30])
    lo = fma_f32(ah, ch, -NOISE_DELTA, "ru")   # the band's smallest float32
    hi = fma_f32(ah, ch, NOISE_DELTA, "rd")    # and largest
    t = f32(rng.uniform(0, 1, m))
    mid = (lo.double() + t.double() * (hi.double() - lo.double())).float()
    mid = torch.minimum(torch.maximum(mid, lo), hi)
    n = torch.cat([lo, hi, mid])
    ah, ch = ah.repeat(3), ch.repeat(3)
    s = torch.as_tensor(np.float32(sigma)) * n
    steps = torch.as_tensor(rng.randint(-3, 4, n.numel()), dtype=torch.float32)
    x = -s
    for _ in range(3):   # x walked a few ulps from -sigma n, by the step's sign
        x = torch.where(steps > 0, torch.nextafter(x, torch.full_like(x, np.inf)),
                        torch.where(steps < 0, torch.nextafter(x, torch.full_like(x, -np.inf)), x))
        steps = steps - steps.sign()
    x = torch.cat([x, f32(rng.randn(n.numel()) * 0.5)])
    return x, n.repeat(2), ah.repeat(2), ch.repeat(2)


@pytest.mark.parametrize("sigma", [0.5, 0.01, -0.3, 0.0, 2.0**99, 2.0**100, np.nan, np.inf,
                                   1e-30])
def test_noisy_decision_never_contradicts_the_exact_sign(sigma):
    x, n, ah, ch = noisy_inputs(11, sigma)
    assert bool(((ah.double() * ch.double() - n.double()).abs() <= float(NOISE_DELTA)).all())
    pos, neg = noisy_decision(x, sigma, ah, ch)
    want = noisy_exact_symbol(x, sigma, n)
    assert not bool((pos & (want != 1)).any()) and not bool((neg & (want != -1)).any())
    if abs(np.float32(sigma)) < 2.0**100:   # the fast path runs: random x mostly decide
        half = x.numel() // 2
        assert float((pos | neg)[half:].float().mean()) > 0.9
    else:
        assert not bool((pos | neg).any())


def test_noisy_decision_on_infinite_and_nan_gradients():
    """x = +-inf decides sign(x), as x + sigma n = x; NaN decides nothing;
    an exact zero sum (-0.0 included) decides nothing (its symbol is 0)."""
    x = f32([np.inf, -np.inf, np.nan, -0.0, 0.0])
    ones = torch.ones(5)
    pos, neg = noisy_decision(x, 0.5, ones, torch.zeros(5))
    assert pos.tolist() == [True, False, False, False, False]
    assert neg.tolist() == [False, True, False, False, False]
    x = f32([-0.25, 0.25])   # sums of 0.0 exactly when n = Â Ĉ = 0.5
    pos, neg = noisy_decision(x, 0.5, torch.ones(2), f32([0.5, -0.5]))
    assert not bool((pos | neg).any())


def test_noisy_band_is_rarely_hit_on_random_draws():
    """N(0, 0.5^2) gradients and sigma 0.5 with Â Ĉ a normal draw: under
    2e-5 of the coordinates fall back (delta = 1e-5; the count seen is
    printed)."""
    rng = np.random.RandomState(13)
    m = 1 << 20
    x = f32(rng.randn(m) * 0.5)
    ah, ch = f32(np.abs(rng.randn(m)) * 1.2), f32(rng.uniform(-1, 1, m))
    pos, neg = noisy_decision(x, 0.5, ah, ch)
    back = int((~(pos | neg)).sum())
    print(f"noisy_sign: {back} of {m} fall back")
    assert back <= 2e-5 * m


# ------------------------------------------------------------ rows 1 and 4 against JAX

def grad_rows(rows: int, n: int, seed: int) -> np.ndarray:
    g = np.random.RandomState(seed).randn(rows, n).astype(np.float32) * 0.4
    g[:, ::97] = 0.0
    g[:, 1::97] = -0.0
    g[0, :5] = [np.nan, np.inf, -np.inf, 1e-30, -1e-30]
    return g


ROW_SHAPES = [(2, 545002), (2, 235146), (5, 4099)]   # the FL rows' widths, an odd n


@pytest.mark.parametrize("rule", ["sparsign", "sign", "stochastic_ternary", "noisy_sign"])
@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_rows_1_and_4_plain_versions_match_jax(rule, shape):
    """Per-row seeds and params at a counter base that wraps: the torch plain
    version of row 4 (and row 1's, for sparsign) equals JAX's oracle row by
    row, bit for bit; noisy_sign to 1 symbol in 10^5, whose log, cos and
    sqrt XLA and torch take from different float32 routines on the CPU."""
    rows, n = shape
    g = grad_rows(rows, n, n + rows)
    seeds = np.array([0xFFFFFFFF, 7, 0x9E3779B9, 1, 2][:rows], np.uint32)
    params = np.array([0.5, 3.0, 0.02, np.nan, 0.0][:rows], np.float32)
    base = 2**32 - 1000
    got = ternary_compress_ref(torch.from_numpy(g), torch.from_numpy(params),
                               torch.from_numpy(seeds.astype(np.int64)), base, rule=rule).numpy()
    want = np.stack([np.asarray(j_ternary_ref(jnp.asarray(g[r]), params[r], np.uint32(seeds[r]),
                                              np.uint32(base), rule=rule))
                     for r in range(rows)])
    flips = int((got != want).sum())
    assert flips <= (1e-5 * got.size if rule == "noisy_sign" else 0), flips
    if rule == "sparsign":
        got1 = sparsign_ref(torch.from_numpy(g), torch.from_numpy(params),
                            torch.from_numpy(seeds.astype(np.int64)), base).numpy()
        want1 = np.stack([np.asarray(j_sparsign_ref(jnp.asarray(g[r]), params[r],
                                                    np.uint32(seeds[r]), np.uint32(base)))
                          for r in range(rows)])
        np.testing.assert_array_equal(got1, want1)
