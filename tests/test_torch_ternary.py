"""The port's ternary family and the Table 1-2 registry rows against the JAX
package, on the CPU.

``ternary_compress_ref`` (the CPU path, and the card's comparison for
``csrc/ternary.cu``) must equal the JAX oracle and the Pallas kernel in
interpret mode bit for bit for sign, sparsign and stochastic_ternary.
noisy_sign is held by a bound on flipped symbols instead: its Box-Muller
noise goes through ``log``, ``cos`` and ``sqrt``, which XLA and torch compute
with different float32 routines on the CPU (on 2^16 uniforms fed through
both, 10.8% of the noise values differed in their bits), so a symbol whose
``g + sigma * n`` lies within an ulp of 0 may flip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithm as jalg
from repro.core import compressors as jcomp
from repro.core import engine as jengine
from repro.core.algorithm import CompressionConfig as JConfig
from repro.core.budgets import BudgetConfig as JBudget
from repro.kernels.ternary.ops import ternary_compress_op as j_ternary_op
from repro.kernels.ternary.ref import ternary_compress_ref as j_ternary_ref
from repro_torch import kernels as tkernels
from repro_torch.core import algorithm as talg
from repro_torch.core import compressors as tcomp
from repro_torch.core import engine as tengine
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.kernels.ternary.kernel import ternary_cuda
from repro_torch.kernels.ternary.ops import ternary_compress_op
from repro_torch.kernels.ternary.ref import ternary_compress_ref

EXACT_RULES = ["sparsign", "sign", "stochastic_ternary"]
RULES = EXACT_RULES + ["noisy_sign"]
SPECIALS = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-30, -1e30, -0.0], np.float32)
#: the noisy_sign flip bound against JAX: at most 1 symbol in 10^5
NOISY_FLIP_RATE = 1e-5


def grad_like(n, seed, scale=0.4):
    g = np.random.RandomState(seed).randn(n).astype(np.float32) * scale
    g[::97] = 0.0
    g[1::97] = -0.0
    g[:8] = SPECIALS[:n]
    return g


def as_dtype(x: np.ndarray, dtype: str):
    if dtype == "bf16":
        return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x).astype(jnp.bfloat16)
    return torch.from_numpy(x), jnp.asarray(x)


def jax_rows(jg, params, seeds, counter_base, rule):
    """The JAX oracle row by row: each worker's message as jax.vmap gives it."""
    return np.stack([np.asarray(j_ternary_ref(jg[r], np.float32(params[r]), np.uint32(seeds[r]),
                                              np.uint32(counter_base), rule=rule))
                     for r in range(len(seeds))])


# ---------------------------------------------------------------- the rules

@pytest.mark.parametrize("rule", EXACT_RULES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,counter_base", [(1, 0), (1001, 2**32 - 300), (2048, 12345)])
def test_ternary_ref_matches_jax_bitwise(rule, dtype, n, counter_base):
    """Per-row seeds and per-row params (budgets, or local-norm scales that
    include a NaN and a zero), an odd n, a counter that wraps, and +-0 / NaN
    / +-inf / tiny inputs in every row."""
    g = np.stack([grad_like(n, n + r) for r in range(4)])
    seeds = np.array([0, 1, 0xFFFFFFFF, 0x9E3779B9], np.uint32)
    params = np.array([0.5, 3.0, 0.0, np.nan], np.float32)
    tg, jg = as_dtype(g, dtype)
    got = ternary_compress_ref(tg, torch.from_numpy(params),
                               torch.from_numpy(seeds.astype(np.int64)), counter_base, rule=rule)
    assert got.dtype == torch.int8 and got.shape == tg.shape
    np.testing.assert_array_equal(got.numpy(), jax_rows(jg, params, seeds, counter_base, rule))


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ternary_ref_matches_pallas_interpret(rule, dtype):
    """One stream over the flat index, as the JAX op takes it (the TPU
    kernel's padded canonical view and its n_valid mask included)."""
    tg, jg = as_dtype(grad_like(1531, 3), dtype)
    want = np.asarray(j_ternary_op(jg, 0.9, np.uint32(77), np.uint32(513), rule=rule,
                                   interpret=True))
    got = ternary_compress_op(tg, 0.9, 77, 513, rule=rule).numpy()
    flips = int((got != want).sum())
    if rule == "noisy_sign":
        assert flips <= NOISY_FLIP_RATE * got.size + 1, flips
    else:
        assert flips == 0


def test_noisy_sign_flip_rate_against_jax():
    """2^20 coordinates with g ~ N(0, 0.01^2) and sigma = 0.01, where the
    noise decides most signs: the share of flipped symbols stays under
    1 in 10^5 (the count seen is printed)."""
    n = 1 << 20
    g = (np.random.RandomState(12).randn(n) * 0.01).astype(np.float32)
    want = np.asarray(j_ternary_ref(jnp.asarray(g), np.float32(0.01), np.uint32(0xC0FFEE),
                                    np.uint32(7), rule="noisy_sign"))
    got = ternary_compress_ref(torch.from_numpy(g), 0.01, 0xC0FFEE, 7, rule="noisy_sign").numpy()
    flips = int((got != want).sum())
    print(f"noisy_sign: {flips} of {n} symbols differ from JAX")
    assert flips <= NOISY_FLIP_RATE * n
    # the noise is real: with sigma = std(g), a quarter of the symbols
    # disagree with sign(g)
    assert 0.24 < np.mean(got != np.sign(g)) < 0.26


def test_noisy_sign_special_values():
    g = np.tile(SPECIALS, 16)
    want = np.asarray(j_ternary_ref(jnp.asarray(g), np.float32(0.5), np.uint32(3), np.uint32(0),
                                    rule="noisy_sign"))
    got = ternary_compress_ref(torch.from_numpy(g), 0.5, 3, rule="noisy_sign").numpy()
    np.testing.assert_array_equal(got[2::8], 0)            # NaN -> 0
    np.testing.assert_array_equal(got[3::8], 1)            # +inf
    np.testing.assert_array_equal(got[4::8], -1)           # -inf
    assert int((got != want).sum()) <= 1


def test_ternary_wrapper_refuses_cpu_and_unknown_rule():
    g = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        ternary_cuda(g, torch.ones(1), torch.zeros(1, dtype=torch.int64), rule="sign")
    with pytest.raises(ValueError, match="unknown ternary rule"):
        ternary_cuda(g, torch.ones(1), torch.zeros(1, dtype=torch.int64), rule="nope")
    tkernels.reset_launch_counts()
    for rule in RULES:
        ternary_compress_op(g, 1.0, 3, rule=rule)
    assert tkernels.launch_counts()["ternary"] == 0


# ---------------------------------------------------------------- registry rows

NEW_ROWS = ["sign", "scaled_sign", "noisy_sign", "qsgd_1bit_l2", "qsgd_1bit_linf", "terngrad"]
LOCAL_SCALE = {"scaled_sign", "qsgd_1bit_l2", "qsgd_1bit_linf", "terngrad"}


def _batch(seed=0, m=4, n=1337):
    rng = np.random.RandomState(seed)
    g = (rng.randn(m, n) * rng.uniform(0.1, 2.0, size=(m, 1))).astype(np.float32)
    g[:, ::31] = 0.0
    seeds = np.array([5, 0xFFFFFFFF, 17, 0x9E3779B9], np.uint32)[:m]
    return g, seeds


@pytest.mark.parametrize("name", NEW_ROWS)
def test_public_shims_match_jax(name):
    g, _ = _batch(1, m=1)
    kw = dict(budget=0.3, seed=11, counter_base=40)
    want = getattr(jcomp, "sign_compressor" if name == "sign" else name)(
        jnp.asarray(g[0]), budget=0.3, seed=np.uint32(11), counter_base=np.uint32(40))
    got = getattr(tcomp, "sign_compressor" if name == "sign" else name)(torch.from_numpy(g[0]), **kw)
    # norms are float sums in another order (XLA against torch): rounding only
    np.testing.assert_allclose(float(got.scale), float(want.scale), rtol=1e-6)
    flips = int((got.values.numpy() != np.asarray(want.values)).sum())
    assert flips <= (NOISY_FLIP_RATE * g.size + 1 if name == "noisy_sign" else 0)
    assert tcomp.get_spec(name).api is getattr(tcomp, "sign_compressor" if name == "sign" else name)


@pytest.mark.parametrize("name", NEW_ROWS)
@pytest.mark.parametrize("batched", [False, True])
def test_compress_leaf_rows_match_jax_engine(name, batched):
    """compress_leaf, one message or all four workers' at once, against the
    JAX engine's jnp backend under jax.vmap: each worker its own norm. The
    scales agree to rtol 1e-6 (sums in another order); the symbols bit for
    bit with the JAX scale passed to both."""
    g, seeds = _batch(2)
    jc = JConfig(compressor=name, budget=JBudget(value=0.01))
    tc = CompressionConfig(compressor=name, budget=BudgetConfig(value=0.01))
    jmsg = jax.vmap(lambda x, s: jengine.compress_leaf(x, jc, s, 9, backend="jnp"))(
        jnp.asarray(g), jnp.asarray(seeds))
    jscale = np.array(jmsg.scale, np.float32).reshape(-1)
    if batched:
        got = tengine.compress_leaf(torch.from_numpy(g), tc, torch.from_numpy(seeds.astype(np.int64)), 9)
        assert got.scale.shape == ((4, 1) if name in LOCAL_SCALE else ())
        scales = got.scale.numpy().reshape(-1)
    else:
        msgs = [tengine.compress_leaf(torch.from_numpy(g[r]), tc, int(seeds[r]), 9) for r in range(4)]
        assert all(m.scale.shape == () for m in msgs)
        got = tcomp.CompressedGrad(values=torch.stack([m.values for m in msgs]),
                                   scale=torch.stack([m.scale for m in msgs]))
        scales = got.scale.numpy()
    np.testing.assert_allclose(np.broadcast_to(scales, jscale.shape), jscale, rtol=1e-6)
    spec = tcomp.get_spec(name)
    param = torch.from_numpy(jscale) if spec.scale_protocol != "none" else 0.01
    symbols = spec.values(torch.from_numpy(g), param, torch.from_numpy(seeds.astype(np.int64)), 9)
    flips = int((symbols.numpy() != np.asarray(jmsg.values)).sum())
    assert flips <= (NOISY_FLIP_RATE * g.size + 1 if name == "noisy_sign" else 0)
    if name in ("sign", "qsgd_1bit_linf", "terngrad"):   # exact scales: the whole message
        np.testing.assert_array_equal(got.values.numpy(), np.asarray(jmsg.values))


def test_terngrad_shared_max_is_one_exact_scalar():
    g, seeds = _batch(3)
    shared = np.float32(np.abs(g).max())
    jc, tc = JConfig(compressor="terngrad"), CompressionConfig(compressor="terngrad")
    jmsg = jax.vmap(lambda x, s: jengine.compress_leaf(x, jc, s, shared_linf=shared,
                                                       backend="jnp"))(jnp.asarray(g), jnp.asarray(seeds))
    got = tengine.compress_leaf(torch.from_numpy(g), tc, torch.from_numpy(seeds.astype(np.int64)),
                                shared_linf=torch.tensor(shared))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(jmsg.values))
    assert got.scale.shape == (4, 1)
    np.testing.assert_array_equal(got.scale.numpy().reshape(-1), np.asarray(jmsg.scale))


def test_compress_tree_and_counter_bases_match_jax():
    rng = np.random.RandomState(4)
    tree = {"b": rng.randn(7).astype(np.float32), "a": [rng.randn(3, 5).astype(np.float32),
                                                       rng.randn(11).astype(np.float32)]}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = {"b": torch.from_numpy(tree["b"]), "a": [torch.from_numpy(x) for x in tree["a"]]}
    assert tcomp.leaf_counter_bases(ttree) == jcomp.leaf_counter_bases(jtree) == [0, 15, 26]
    for name in ("sparsign", "terngrad", "sign"):
        want = jcomp.compress_tree(jtree, name=name, budget=2.0, seed=np.uint32(9), extra_salt=3)
        got = tcomp.compress_tree(ttree, name=name, budget=2.0, seed=9, extra_salt=3)
        for w, t in zip(jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(
                x, jcomp.CompressedGrad)), [got["a"][0], got["a"][1], got["b"]]):
            np.testing.assert_array_equal(t.values.numpy(), np.asarray(w.values))
            np.testing.assert_array_equal(np.float32(t.scale), np.asarray(w.scale))


@pytest.mark.parametrize("name,server", [("terngrad", "mean"), ("qsgd_1bit_linf", "mean"),
                                         ("scaled_sign", "mean"), ("sign", "majority_vote")])
def test_reference_round_with_scales_matches_jax(name, server):
    """core/algorithm.reference_round on the new rows: each worker's message
    decoded with its own norm, masked, averaged and stepped by the mean (or
    majority) server. Exact where the norm is (L-inf, sign); the L1 mean is a
    sum in another order, so scaled_sign is held to rtol 1e-6."""
    g, _ = _batch(5)
    rng = np.random.RandomState(6)
    w = rng.randn(g.shape[1]).astype(np.float32)
    mask = np.array([1, 0, 1, 1], bool)
    jw, _ = jalg.reference_round(jnp.asarray(w), jnp.asarray(g),
                                 JConfig(compressor=name, server=server), eta=0.02,
                                 seed=np.uint32(8), participation_mask=jnp.asarray(mask))
    tw, _ = talg.reference_round(torch.from_numpy(w), torch.from_numpy(g),
                                 CompressionConfig(compressor=name, server=server), eta=0.02,
                                 seed=8, participation_mask=torch.from_numpy(mask))
    if name == "scaled_sign":
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(tw.numpy().view(np.int32), np.asarray(jw).view(np.int32))
