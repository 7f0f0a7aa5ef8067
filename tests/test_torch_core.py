"""The port's core modules against the JAX package, on the CPU: the counter
hash and seeds, budgets, aggregation and error feedback, the bit model, the
compressor registry, the engine and the Alg. 2 worker loop. Bitwise wherever
the reference is integer or exactly rounded; ``allclose`` only where a float
reduction runs in another order (stated at each use)."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithm as jalg
from repro.core import budgets as jbudgets
from repro.core import encoding as jenc
from repro.core import engine as jengine
from repro.core import prng as jprng
from repro.core.aggregation import alpha_of_scaled_sign as j_alpha
from repro.core.aggregation import majority_vote as j_majority
from repro.core.aggregation import scaled_sign_server as j_scaled_sign
from repro.core.error_feedback import EFState as JEFState
from repro.core.error_feedback import ef_server_step as j_ef_step
import repro_torch
from repro_torch.core import algorithm as talg
from repro_torch.core import budgets as tbudgets
from repro_torch.core import compressors as tcomp
from repro_torch.core import encoding as tenc
from repro_torch.core import engine as tengine
from repro_torch.core import prng as tprng
from repro_torch.core.aggregation import alpha_of_scaled_sign, majority_vote, scaled_sign_server
from repro_torch.core.error_feedback import EFState, ef_server_step, init_ef
from repro_torch.fl import simulation as tsim

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEEDS = [0, 1, 0x9E3779B9, 0xFFFFFFFF]


def f32bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float32).view(torch.int32).numpy()
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------- prng

@pytest.mark.parametrize("seed", SEEDS)
def test_uniform01_bitwise_near_counter_wrap(seed):
    counters = np.concatenate([np.arange(2**32 - 4096, 2**32, dtype=np.uint64),
                               np.arange(0, 4096, dtype=np.uint64)]).astype(np.uint32)
    want = jprng.uniform01(np.uint32(seed), jnp.asarray(counters))
    got = tprng.uniform01(seed, torch.from_numpy(counters.astype(np.int64)))
    np.testing.assert_array_equal(f32bits(got), f32bits(want))
    np.testing.assert_array_equal(
        tprng.hash_counter(seed, torch.from_numpy(counters.astype(np.int64))).numpy(),
        np.asarray(jprng.hash_counter(np.uint32(seed), jnp.asarray(counters))).astype(np.int64))


def test_fold_seed_host_and_tensor_twins_bitwise():
    salts = [(0x5EED,), (1001,), (2,), (0x5EED, 7, 0xFFFFFFFF)]
    for seed in SEEDS:
        for s in salts:
            want = int(jprng.fold_seed(jnp.uint32(seed), *s))
            assert tprng.fold_seed_int(seed, *s) == want
            assert int(tprng.fold_seed(torch.tensor(seed), *s)) == want
    x = np.array(SEEDS, np.uint32)
    np.testing.assert_array_equal(tprng.mix32(torch.from_numpy(x.astype(np.int64))).numpy(),
                                  np.asarray(jprng.mix32(jnp.asarray(x))).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_per_worker_round_seed_formula_bitwise(seed):
    """fold_seed(seed, 0x5EED) + widx*0x9E3779B9 + round*0x85EBCA6B (mod 2^32),
    as fl/simulation.py computes it, for the port's host ints and tensors."""
    widx = np.array([0, 1, 19, 99], np.int32)
    for r in (0, 7, 10**6):
        want = (jprng.fold_seed(jnp.uint32(seed), 0x5EED)
                + jnp.asarray(widx).astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
                + jnp.uint32(r) * jnp.uint32(0x85EBCA6B))
        got = (talg.worker_stream_seed(seed, torch.from_numpy(widx))
               + r * tsim.ROUND_SEED_MUL) & tprng.MASK32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
        assert [(talg.worker_stream_seed(seed, int(w)) + r * tsim.ROUND_SEED_MUL)
                & tprng.MASK32 for w in widx] == np.asarray(want).astype(np.int64).tolist()
    assert talg.worker_stream_seed(seed, 5) == int(jalg.worker_stream_seed(np.uint32(seed), 5))


# ---------------------------------------------------------------- budgets

def heavy_grad(n=4000, seed=0):
    g = np.random.RandomState(seed).standard_cauchy(n).astype(np.float32) * 1e-3
    g[::10] = 0.0
    return g


def test_budgets_match_jax():
    g = heavy_grad()
    tg, jg = torch.from_numpy(g), jnp.asarray(g)
    fixed = jbudgets.BudgetConfig(kind="fixed", value=0.3)
    np.testing.assert_array_equal(
        f32bits(tbudgets.resolve_budget(tbudgets.BudgetConfig(kind="fixed", value=0.3), tg)),
        f32bits(jbudgets.resolve_budget(fixed, jg)))
    # max and norm reductions: rounding of the norm's summation order only
    for kind, value in (("linf_share", 1.0), ("l2_norm", 2.0)):
        want = float(jbudgets.resolve_budget(jbudgets.BudgetConfig(kind=kind, value=value), jg))
        got = float(tbudgets.resolve_budget(tbudgets.BudgetConfig(kind=kind, value=value), tg))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    shared = float(tbudgets.resolve_budget(tbudgets.BudgetConfig(kind="linf_share"), tg,
                                           shared_linf=2.0))
    assert shared == float(np.float32(1.0) / np.float32(2.0))


def test_target_sparsity_bisection_hits_target_per_row():
    g = np.stack([heavy_grad(3000, s) for s in range(3)])
    cfg = tbudgets.BudgetConfig(kind="target_sparsity", value=0.05)
    rows = tbudgets.resolve_budget(cfg, torch.from_numpy(g), rows=True)
    assert rows.shape == (3,)
    for r in range(3):
        one = tbudgets.resolve_budget(cfg, torch.from_numpy(g[r]))
        jb = float(jbudgets.solve_budget_for_sparsity(jnp.asarray(g[r]), 0.05))
        # the per-step mean is summed in another order, so a bisection branch
        # near the target may differ: compare the solved sparsity, not bits
        assert float(one) == pytest.approx(float(rows[r]), rel=1e-5)
        got = float(tbudgets.expected_sparsity(torch.from_numpy(g[r]), one))
        want = float(jbudgets.expected_sparsity(jnp.asarray(g[r]), jb))
        assert got == pytest.approx(0.05, rel=1e-3) and want == pytest.approx(0.05, rel=1e-3)


# ---------------------------------------------------------------- server math

def test_aggregation_and_error_feedback_match_jax():
    rng = np.random.RandomState(1)
    v = rng.randint(-4, 5, size=999).astype(np.int32)
    np.testing.assert_array_equal(majority_vote(torch.from_numpy(v)).numpy(),
                                  np.asarray(j_majority(jnp.asarray(v))))
    x = rng.randn(999).astype(np.float32)
    # L1 and L2 sums in another order: float rounding only
    np.testing.assert_allclose(scaled_sign_server(torch.from_numpy(x)).numpy(),
                               np.asarray(j_scaled_sign(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(float(alpha_of_scaled_sign(torch.from_numpy(x))),
                               float(j_alpha(jnp.asarray(x))), rtol=1e-5)
    e = (rng.randn(999) * 0.1).astype(np.float32)
    g_t, st = ef_server_step(EFState(torch.from_numpy(e)), torch.from_numpy(x))
    g_j, sj = j_ef_step(JEFState(jnp.asarray(e)), jnp.asarray(x))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-6)
    np.testing.assert_allclose(st.residual.numpy(), np.asarray(sj.residual), rtol=1e-5,
                               atol=1e-6)
    assert init_ef(torch.zeros(3, 4)).residual.shape == (3, 4)


@pytest.mark.parametrize("p", [1e-12, 1e-3, 0.05, 0.5, 0.999])
def test_bit_model_matches_jax(p):
    assert tenc.golomb_bstar(p) == jenc.golomb_bstar(p)
    assert tenc.golomb_bits_per_index(p) == jenc.golomb_bits_per_index(p)
    for coder in ("golomb", "dense", "naive_index", "packed2bit"):
        assert (tenc.ternary_stream_bits(545002, int(p * 545002), coder=coder)
                == jenc.ternary_stream_bits(545002, int(p * 545002), coder=coder))
    for algo in tcomp.SPECS:
        assert (tenc.baseline_bits_per_round(545002, algo, nnz=p * 545002)
                == jenc.baseline_bits_per_round(545002, algo, nnz=p * 545002))


# ---------------------------------------------------------------- registry

def test_registry_rows_and_not_yet_ported_names():
    """Every row of the JAX table, the pack8 row ``qsgd8`` included, with the
    JAX row's ternariness, scale protocol, server decode, wire format and
    fused op; nothing is left to port, and an unknown name raises."""
    from repro.core import compressors as jcomp
    assert sorted(tcomp.SPECS) == sorted(jcomp.SPECS)
    for name, spec in tcomp.SPECS.items():
        j = jcomp.SPECS[name]
        assert (spec.is_ternary, spec.scale_protocol, spec.server_decode, spec.chunkable,
                spec.uplink_bits, spec.wire_format) == (j.is_ternary, j.scale_protocol,
                                                        j.server_decode, j.chunkable,
                                                        j.uplink_bits, j.wire_format), name
        assert (spec.kernel_op is None) == (j.pallas_op is None), name
        assert (spec.fused_pack_op is None) == (j.fused_pack_op is None), name
    assert tcomp.get_spec("qsgd8").wire_format == "pack8"
    assert not hasattr(tcomp, "NOT_YET_PORTED")
    with pytest.raises(KeyError, match="unknown compressor"):
        tcomp.get_spec("nope")
    g = torch.from_numpy(heavy_grad(50))
    msg = tengine.compress_leaf(g, talg.CompressionConfig(
        budget=tbudgets.BudgetConfig(value=100.0)), 3)
    assert msg.values.dtype == torch.int8 and float(msg.scale) == 1.0
    assert msg.decode().dtype == torch.float32
    ident = tengine.compress_leaf(g, talg.CompressionConfig(compressor="identity"), 3)
    assert ident.values is g and float(ident.scale) == 1.0


@pytest.mark.parametrize("batched", [False, True])
def test_chunked_values_is_stream_identical(batched):
    g = torch.from_numpy(np.stack([heavy_grad(1001, s) for s in range(3)]) * 1e3)
    seed = torch.tensor([4, 5, 6]) if batched else 4
    one = tcomp.chunked_values(tcomp.SPECS["sparsign"].values, g, 1.0, seed, 17)
    chunked = tcomp.chunked_values(tcomp.SPECS["sparsign"].values, g, 1.0, seed, 17,
                                   max_chunk=256)
    np.testing.assert_array_equal(one.numpy(), chunked.numpy())


# ---------------------------------------------------------------- engine

def test_resolve_backend_follows_the_tensor():
    x = torch.zeros(3)
    assert tengine.resolve_backend(None, x) == "torch"
    assert tengine.resolve_backend("torch", x) == "torch"
    with pytest.raises(ValueError, match="CUDA tensor"):
        tengine.resolve_backend("cuda", x)
    with pytest.raises(ValueError, match="unknown kernel backend"):
        tengine.resolve_backend("pallas", x)
    for rule in ("majority_vote", "scaled_sign_ef", "mean"):
        assert tengine.needs_server_ef(rule) == jengine.needs_server_ef(rule)


def test_entry_points_refuse_to_run_on_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device(None)
    assert repro_torch.resolve_device("cpu").type == "cpu"


def _cfgs():
    mv = jalg.CompressionConfig(budget=jbudgets.BudgetConfig(value=2.0))
    ef = jalg.CompressionConfig(budget=jbudgets.BudgetConfig(value=2.0), server="scaled_sign_ef")
    tmv = talg.CompressionConfig(budget=tbudgets.BudgetConfig(value=2.0))
    tef = talg.CompressionConfig(budget=tbudgets.BudgetConfig(value=2.0), server="scaled_sign_ef")
    return mv, ef, tmv, tef


def test_compress_leaf_matches_jax_engine_bitwise():
    mv, _, tmv, _ = _cfgs()
    g = heavy_grad(2500, 3) * 300
    want = jengine.compress_leaf(jnp.asarray(g), mv, np.uint32(0xFFFFFFFF), np.uint32(40),
                                 backend="jnp")
    got = tengine.compress_leaf(torch.from_numpy(g), tmv, 0xFFFFFFFF, 40)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert float(got.scale) == float(want.scale)


def test_server_apply_matches_jax_engine():
    mv, ef, tmv, tef = _cfgs()
    rng = np.random.RandomState(5)
    p = rng.randn(1200).astype(np.float32)
    ivotes = rng.randint(-5, 6, size=1200).astype(np.int32)
    fvotes = ivotes.astype(np.float32)
    e0 = (rng.randn(1200) * 0.01).astype(np.float32)
    for votes in (ivotes, fvotes):
        for q in (1, 3):
            jp, _ = jengine.server_apply(jnp.asarray(p), jnp.asarray(votes), mv, lr=0.05,
                                         quorum=q, backend="jnp")
            tp, _ = tengine.server_apply(torch.from_numpy(p), torch.from_numpy(votes), tmv,
                                         lr=0.05, quorum=q)
            np.testing.assert_array_equal(f32bits(tp), f32bits(jp))
    jp, _ = jengine.server_apply(jnp.asarray(p), jnp.asarray(fvotes), mv, lr=0.05, n_sel=4.0,
                                 server="mean", scale=0.5, backend="jnp")
    tp, _ = tengine.server_apply(torch.from_numpy(p), torch.from_numpy(fvotes), tmv, lr=0.05,
                                 n_sel=4.0, server="mean", scale=0.5)
    np.testing.assert_array_equal(f32bits(tp), f32bits(jp))
    jp, je = jengine.server_apply(jnp.asarray(p), jnp.asarray(fvotes), ef, lr=0.05,
                                  ef=jnp.asarray(e0), n_sel=20.0, backend="jnp")
    tp, te = tengine.server_apply(torch.from_numpy(p), torch.from_numpy(fvotes), tef, lr=0.05,
                                  ef=torch.from_numpy(e0), n_sel=20.0)
    # the EF scale is an L1 sum, reduced in another order by XLA and torch
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-6)
    # the elastic branch: a weighted float vote against q_frac * W
    wv = fvotes * np.float32(0.75)
    jp, _ = jengine.server_apply(jnp.asarray(p), jnp.asarray(wv), mv, lr=0.05,
                                 part_total=jnp.float32(6.0), q_frac=0.5, backend="jnp")
    tp, _ = tengine.server_apply(torch.from_numpy(p), torch.from_numpy(wv), tmv, lr=0.05,
                                 part_total=torch.tensor(6.0), q_frac=0.5)
    np.testing.assert_array_equal(f32bits(tp), f32bits(jp))
    with pytest.raises(ValueError, match="scaled_sign_ef"):
        tengine.server_apply(torch.from_numpy(p), torch.from_numpy(fvotes), tef, lr=0.1,
                             ef=torch.from_numpy(e0), n_sel=4.0, part_total=4.0)


# ---------------------------------------------------------------- algorithm

@pytest.mark.parametrize("tau", [1, 3])
def test_local_update_source_bitwise_with_elementwise_grad(tau):
    rng = np.random.RandomState(tau)
    w0 = rng.randn(1500).astype(np.float32)
    targets = rng.randn(tau, 1500).astype(np.float32)
    jcfg = jalg.CompressionConfig(server="scaled_sign_ef", local_steps=tau, local_budget=10.0)
    tcfg = talg.CompressionConfig(server="scaled_sign_ef", local_steps=tau, local_budget=10.0)
    jt = jnp.asarray(targets)
    want = jalg.local_update_source(jnp.asarray(w0), lambda w, c: w - jt[c], jcfg,
                                    eta_l=0.05, seed=np.uint32(0xFFFFFFF0), counter_base=3,
                                    backend="jnp")
    tt = torch.from_numpy(targets)
    got = talg.local_update_source(torch.from_numpy(w0), lambda w, c: w - tt[c], tcfg,
                                   eta_l=0.05, seed=0xFFFFFFF0, counter_base=3)
    np.testing.assert_array_equal(f32bits(got), f32bits(want))
    # the batched form: two workers in one call, each its own stream
    seeds = torch.tensor([0xFFFFFFF0, 12])
    both = talg.local_update_source(torch.from_numpy(np.stack([w0, w0])),
                                    lambda w, c: w - tt[c], tcfg, eta_l=0.05, seed=seeds,
                                    counter_base=3)
    np.testing.assert_array_equal(f32bits(both[0]), f32bits(want))
    msg = talg.local_update_message(torch.from_numpy(w0), lambda w, c: w - tt[c], tcfg,
                                    eta_l=0.05, seed=0xFFFFFFF0, counter_base=3)
    jmsg = jalg.local_update_message(jnp.asarray(w0), lambda w, c: w - jt[c], jcfg,
                                     eta_l=0.05, seed=np.uint32(0xFFFFFFF0), counter_base=3,
                                     backend="jnp")
    np.testing.assert_array_equal(msg.values.numpy(), np.asarray(jmsg.values))


def test_reference_round_majority_bitwise():
    rng = np.random.RandomState(9)
    w = rng.randn(700).astype(np.float32)
    grads = rng.randn(5, 700).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1], bool)
    jw, _ = jalg.reference_round(jnp.asarray(w), jnp.asarray(grads), jalg.CompressionConfig(),
                                 eta=0.01, seed=np.uint32(3), participation_mask=jnp.asarray(mask))
    tw, _ = talg.reference_round(torch.from_numpy(w), torch.from_numpy(grads),
                                 talg.CompressionConfig(), eta=0.01, seed=3,
                                 participation_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(f32bits(tw), f32bits(jw))
    with pytest.raises(ValueError, match="tau"):
        talg.CompressionConfig(local_steps=0)


# ---------------------------------------------------------------- isolation

def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
