"""The identities that the shared 2-bit encoder (``csrc/pack2_encode.cuh``)
rests on, held on the CPU where the kernel cannot run, and its plain
versions against each other and the JAX package:

- the clamp: u < clip(r, 0, 1) == u < r for every u = k * 2^-24, k < 2^24;
- the margin: the sign bit of u - r is u < r (subnormals kept; a NaN r gives
  the card's canonical NaN, whose sign bit is clear, held on the card by
  ``chip_smoke.py`` phase 5 and ``tests/test_torch_cuda.py``);
- the seed folded into mix32's first xor-shift, and the top 24 bits kept in
  place, ``uniform01_folded``, equal to ``repro_torch.core.prng.uniform01``;
- the compare the kernel adopts, on subnormal products that round to 0,
  against the plain formula, and why a rescaled compare was not adopted;
- ``sparsign_pack2bit_ref`` == ``ternary_pack2bit_ref(rule="sparsign")``
  byte for byte, and both equal to the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sparsign_pack2bit.ref import sparsign_pack2bit_ref as j_sparsign_pack_ref
from repro.kernels.ternary.ref import ternary_pack2bit_ref as j_ternary_pack_ref
from repro_torch.core import prng
from repro_torch.kernels.sparsign_pack2bit.ref import sparsign_pack2bit_ref
from repro_torch.kernels.ternary.ref import ternary_pack2bit_ref

M32 = np.uint64(0xFFFFFFFF)


def f32(bits) -> np.ndarray:
    return np.asarray(bits, np.uint32).view(np.float32)


def probabilities() -> np.ndarray:
    """r at +-0, NaN, +-inf, negatives, subnormals, 1 +- ulp, k * 2^-24 +- ulp
    and ordinary values in (0, 1)."""
    one = np.float32(1.0)
    grid = (np.array([1, 2, 3, 255, 256, 2**23 - 1, 2**23, 2**23 + 1, 2**24 - 1],
                     np.float32) * np.float32(2.0**-24))
    r = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, -1.0, -1e-30, -f32(1)[()],
         f32(1)[()], f32(0x007FFFFF)[()], f32(0x00800000)[()], 2.0**-149, 2.0**-130,
         np.nextafter(one, np.float32(0)), one, np.nextafter(one, np.float32(2)), 2.0, 1e30,
         0.5, 0.3, 1.0 / 3.0, 0.999]
    r += list(grid) + list(np.nextafter(grid, np.float32(0))) + list(
        np.nextafter(grid, np.float32(2)))
    return np.array(r, np.float32)


def uniforms() -> np.ndarray:
    """u = k * 2^-24: every k within 2^12 of 0, 2^23 and 2^24, and 2^16 drawn."""
    edges = np.concatenate([np.arange(0, 4096), np.arange(2**23 - 4096, 2**23 + 4096),
                            np.arange(2**24 - 4096, 2**24)])
    rest = np.random.RandomState(0).randint(0, 2**24, 2**16)
    k = np.concatenate([edges, rest]).astype(np.int64)
    return (torch.from_numpy(k).to(torch.float32) * 2.0**-24).numpy()


def test_clamp_is_redundant_against_a_24_bit_uniform():
    u = torch.from_numpy(uniforms())[:, None]
    r = torch.from_numpy(probabilities())[None, :]
    assert torch.equal(u < torch.clamp(r, 0.0, 1.0), u < r)


def test_margin_sign_bit_is_the_compare():
    u = torch.from_numpy(uniforms())[:, None]
    r = torch.from_numpy(probabilities())
    r = r[~torch.isnan(r)][None, :]
    margin = (u - r).view(torch.int32)
    assert torch.equal(margin < 0, u < r)


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & M32
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(prng.C1)) & M32
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(prng.C2)) & M32
    return x ^ (x >> np.uint64(16))


def uniform01_folded_np(folded: np.ndarray, a: np.ndarray) -> np.ndarray:
    """common.cuh's uniform01_folded in numpy: ``folded`` is fold_hash of the
    stream's seed hash, ``a`` the counter times the golden ratio (uint32)."""
    x = a ^ (a >> np.uint64(16)) ^ folded
    x = (x * np.uint64(prng.C1)) & M32
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(prng.C2)) & M32
    x = (x ^ (x >> np.uint64(16))) & np.uint64(0xFFFFFF00)
    return x.astype(np.float32) * np.float32(2.0**-32)


def u32_samples(n: int, seed: int) -> np.ndarray:
    edges = np.array([0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFF0000, 0xFFFFFFFE,
                      0xFFFFFFFF], np.uint64)
    rand = np.random.RandomState(seed).randint(0, 2**32, n, dtype=np.uint64)
    return np.concatenate([edges, rand])


def test_seed_folds_into_the_first_xor_shift():
    a = u32_samples(1 << 16, 1)[:, None]
    s = u32_samples(64, 2)[None, :]
    sixteen = np.uint64(16)
    assert np.array_equal((a ^ s) ^ ((a ^ s) >> sixteen),
                          a ^ (a >> sixteen) ^ (s ^ (s >> sixteen)))


@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B9, 0xFFFFFFFF, 123456789])
def test_uniform01_folded_is_prng_uniform01(seed):
    counters = u32_samples(1 << 15, seed & 0xFFFF)
    s = _mix32_np(np.array([seed + prng.GOLDEN], np.uint64))
    folded = s ^ (s >> np.uint64(16))
    a = (counters * np.uint64(prng.GOLDEN)) & M32
    got = uniform01_folded_np(folded, a)
    want = prng.uniform01(seed, torch.from_numpy(counters.astype(np.int64))).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_adopted_compare_on_subnormal_products():
    """The kernel compares u = float(top 24 bits) * 2^-24 with RN(|x| * B) as
    the plain formula does, so a product that rounds to 0 keeps nothing.
    Folding 2^24 into B (u's integer k against RN(|x| * B * 2^24)) would keep
    k = 0 there: it is not adopted."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(np.concatenate([
        f32(rng.randint(1, 0x00800000, 4096)),                # subnormal |x|
        np.array([2.0**-149, 2.0**-140, 2.0**-126, 1e-30], np.float32)]))
    b = torch.tensor([2.0**-24, 2.0**-8, 0.3, 1.0, 2.0**20], dtype=torch.float32)[:, None]
    k = torch.tensor([0, 1, 2, 2**23, 2**24 - 1], dtype=torch.float32)[:, None, None]
    u = k * 2.0**-24
    p = torch.abs(x)[None, :] * b                            # RN(|x| * B), float32
    plain = u < torch.clamp(p, 0.0, 1.0)
    adopted = (u - p).view(torch.int32) < 0
    assert torch.equal(adopted, plain)
    underflow = (p == 0) & (torch.abs(x)[None, :] > 0)
    assert bool(underflow.any())                              # products that round to 0
    rescaled = k < torch.abs(x)[None, :] * (b * 2.0**24)
    assert bool((rescaled != plain)[:, underflow].any())


def grads(n: int, seed: int) -> np.ndarray:
    g = np.random.RandomState(seed).randn(n).astype(np.float32) * 0.5
    specials = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-30, -1e30, 2.0**-140],
                        np.float32)
    g[:8] = specials[:n]
    g[::97] = 0.0
    return g


@pytest.mark.parametrize("n,dtype,cb", [(1, torch.float32, 0), (513, torch.bfloat16, 2**32 - 7),
                                        (8193, torch.float32, 5),
                                        (3 * 8192 + 17, torch.bfloat16, 9)])
def test_sparsign_pack2bit_is_the_ternary_sparsign_rule(n, dtype, cb):
    g = torch.from_numpy(grads(n, n)).to(dtype)
    for budget in (1.0, 0.0, float("nan"), float("inf"), 2.0**24):
        a = sparsign_pack2bit_ref(g, budget, 0xC0FFEE, cb)
        b = ternary_pack2bit_ref(g, budget, 0xC0FFEE, cb, rule="sparsign")
        assert torch.equal(a, b)
        if budget == 1.0:   # and the JAX package's plain versions, on float32 values
            gj = jnp.asarray(g.to(torch.float32).numpy())
            np.testing.assert_array_equal(
                a.numpy(), np.asarray(j_sparsign_pack_ref(gj, budget, 0xC0FFEE, cb)))
            np.testing.assert_array_equal(
                b.numpy(), np.asarray(j_ternary_pack_ref(gj, budget, 0xC0FFEE, cb,
                                                         rule="sparsign")))
