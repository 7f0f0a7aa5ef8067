"""The port's federated round against the JAX package, on the CPU.

Worker sampling, batch draws and ``jax.grad``'s summation order are not
reproducible in torch, so parity is held at the round level: the same
per-worker sources and seeds go through both packages' server halves. The
models are compared through the JAX initial vector carried over, and the
run-level claim of tests/test_fl.py is reproduced by the port's own run_fl."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import prng as jprng
from repro.core.algorithm import CompressionConfig as JConfig
from repro.core.budgets import BudgetConfig as JBudget
from repro.data.dirichlet import dirichlet_partition as j_partition
from repro.data.synthetic import ImageDataConfig as JImageCfg
from repro.data.synthetic import make_image_dataset as j_dataset
from repro.fl import models as jmodels
from repro_torch import kernels as tkernels
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.synthetic import ImageDataConfig, make_image_dataset
from repro_torch.fl import models as tmodels
from repro_torch.fl.simulation import FLConfig, build_round_fn, run_fl, stack_partitions


def f32bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float32).view(torch.int32).numpy()
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------- models

MODELS = {
    "mlp": (lambda key: jmodels.mlp_fashion(key, in_dim=48, hidden=(16, 8)),
            lambda: tmodels.mlp_fashion(in_dim=48, hidden=(16, 8), device="cpu"), (48,)),
    "cnn": (lambda key: jmodels.cnn_cifar(key, shape=(8, 8, 3), width=4),
            lambda: tmodels.cnn_cifar(shape=(8, 8, 3), width=4, device="cpu"), (8, 8, 3)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_forward_and_per_example_grads_match_jax(name):
    jmake, tmake, xshape = MODELS[name]
    v0, japply = jmake(jax.random.PRNGKey(3))
    tv_own, tapply = tmake()
    assert tv_own.shape == v0.shape  # same parameter count and layout
    v = tmodels.from_jax_vector(np.asarray(v0), "cpu", layout=tapply.layout)
    rng = np.random.RandomState(0)
    x = rng.randn(6, *xshape).astype(np.float32)
    y = rng.randint(0, 10, size=6).astype(np.int32)
    # products and convolutions sum in another order in XLA and in torch
    np.testing.assert_allclose(tapply(v, torch.from_numpy(x)).detach().numpy(),
                               np.asarray(japply(v0, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    jloss, tloss = jmodels.xent_loss(japply), tmodels.xent_loss(tapply)
    jg = jax.vmap(jax.grad(lambda w, xi, yi: jloss(w, xi[None], yi[None])),
                  in_axes=(None, 0, 0))(v0, jnp.asarray(x), jnp.asarray(y))
    tg = torch.func.vmap(torch.func.grad(lambda w, xi, yi: tloss(w, xi[None], yi[None])),
                         in_dims=(None, 0, 0))(v, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="layout"):
        tmodels.from_jax_vector(np.zeros(5, np.float32), "cpu", layout=tapply.layout)


def test_full_width_cnn_layout_is_the_jax_vector():
    layout = tmodels.cnn_layout()
    assert [k for k, _ in layout.entries] == ["b1", "b2", "c1", "c2", "w1", "w2"]
    assert layout.size == 545002
    assert [k for k, _ in tmodels.mlp_layout().entries] == ["b0", "b1", "b2", "w0", "w1", "w2"]


def test_data_copies_match_jax():
    cfg = dict(n_train=300, n_test=50, shape=(8, 8, 3), seed=4)
    for a, b in zip(make_image_dataset(ImageDataConfig(**cfg)), j_dataset(JImageCfg(**cfg))):
        np.testing.assert_array_equal(a, b)
    y = make_image_dataset(ImageDataConfig(**cfg))[1]
    for a, b in zip(dirichlet_partition(y, 7, 0.5, seed=2), j_partition(y, 7, 0.5, seed=2)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- one round

D, M = 1337, 6


def _round_inputs(seed=0):
    rng = np.random.RandomState(seed)
    v = rng.randn(D).astype(np.float32)
    srcs = (rng.randn(M, D) * 0.5).astype(np.float32)
    srcs[:, ::40] = 0.0
    ef = (rng.randn(D) * 0.01).astype(np.float32)
    widx = np.array([5, 0, 3, 1, 4, 2], np.uint32)
    seeds = (jprng.fold_seed(jnp.uint32(11), 0x5EED) + jnp.asarray(widx) * jnp.uint32(0x9E3779B9)
             + jnp.uint32(7) * jnp.uint32(0x85EBCA6B))
    return v, srcs, ef, np.asarray(seeds)


def _jax_server_half(v, ef, srcs, seeds, comp, n_sel):
    """fl/simulation.py's server half (lines 116-169) on injected sources."""
    server_rule = comp.server if jengine.is_vote_server(comp) else "mean"

    def msg(s, sd):
        m = jengine.compress_leaf(s, comp, sd, backend="jnp")
        return m.values.astype(jnp.float32) * m.scale, jnp.sum(jnp.abs(jnp.sign(m.values)))

    dec, nnz = jax.vmap(msg)(jnp.asarray(srcs), jnp.asarray(seeds))
    v2, ef2 = jengine.server_apply(jnp.asarray(v), jnp.sum(dec, axis=0), comp, lr=0.03,
                                   ef=jnp.asarray(ef), n_sel=jnp.float32(n_sel),
                                   server=server_rule, backend="jnp")
    return v2, ef2, jnp.mean(nnz.astype(jnp.float32))


def _port_round_fn(comp):
    cfg = FLConfig(n_workers=M, participation=1.0, lr=0.03, comp=comp)
    xp = np.zeros((M, 4, 2), np.float32)
    yp = np.zeros((M, 4), np.int32)
    return build_round_fn(lambda v, x, y: v.sum(), cfg, xp, yp, device="cpu")


@pytest.mark.parametrize("server", ["majority_vote", "scaled_sign_ef"])
def test_server_half_with_injected_sources_matches_jax(server):
    v, srcs, ef, seeds = _round_inputs()
    jcomp = JConfig(budget=JBudget(value=1.5), server=server)
    tcomp = CompressionConfig(budget=BudgetConfig(value=1.5), server=server)
    jv, jef, jnnz = _jax_server_half(v, ef, srcs, seeds, jcomp, M)
    tv, tef, tnnz = _port_round_fn(tcomp).server(
        torch.from_numpy(v), torch.from_numpy(ef), torch.from_numpy(srcs),
        torch.from_numpy(seeds.astype(np.int64)))
    # integer counts; XLA divides the mean by a reciprocal product, torch exactly
    assert float(tnnz) == pytest.approx(float(jnnz), rel=1e-6)
    if server == "majority_vote":
        np.testing.assert_array_equal(f32bits(tv), f32bits(jv))
        np.testing.assert_array_equal(f32bits(tef), f32bits(jef))
    else:
        # the EF scale is an L1 sum taken in another order: rounding only
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tef.numpy(), np.asarray(jef), rtol=1e-5, atol=1e-6)


def test_integer_vote_round_matches_jax_bitwise():
    """The single-process form of the psum wire: int8 messages summed in
    int32, then the vote_update server (kernel 2 on the card)."""
    v, srcs, _, seeds = _round_inputs(1)
    jcomp, tcomp = JConfig(budget=JBudget(value=1.0)), CompressionConfig()
    jmsgs = jax.vmap(lambda s, sd: jengine.compress_leaf(s, jcomp, sd, backend="jnp").values)(
        jnp.asarray(srcs), jnp.asarray(seeds))
    jv, _ = jengine.server_apply(jnp.asarray(v), jnp.sum(jmsgs.astype(jnp.int32), axis=0),
                                 jcomp, lr=0.03, quorum=2, backend="jnp")
    from repro_torch.core import engine as tengine
    msgs = tengine.compress_leaf(torch.from_numpy(srcs), tcomp,
                                 torch.from_numpy(seeds.astype(np.int64)))
    np.testing.assert_array_equal(msgs.values.numpy(), np.asarray(jmsgs))
    tv, _ = tengine.server_apply(torch.from_numpy(v), msgs.values.sum(0, dtype=torch.int32),
                                 tcomp, lr=0.03, quorum=2)
    np.testing.assert_array_equal(f32bits(tv), f32bits(jv))


def test_elastic_fields_fail_at_build():
    """Elastic participation with the EF server fails when the round is
    built, as in the JAX package: the server residual cannot be
    participation-normalized. A malformed elastic field fails there too."""
    ef = CompressionConfig(server="scaled_sign_ef")
    for elastic in (dict(q_frac=0.5), dict(dropout=0.1), dict(worker_weights=(1.0, 2.0))):
        with pytest.raises(ValueError, match="scaled_sign_ef"):
            build_round_fn(lambda v, x, y: v.sum(), FLConfig(n_workers=2, comp=ef, **elastic),
                           np.zeros((2, 1)), np.zeros((2, 1)), device="cpu")
    with pytest.raises(ValueError, match="scaled_sign_ef"):
        jengine.check_participation_server("scaled_sign_ef", "sparsign")
    with pytest.raises(ValueError, match="quorum fraction"):
        build_round_fn(lambda v, x, y: v.sum(), FLConfig(n_workers=2, q_frac=1.5),
                       np.zeros((2, 1)), np.zeros((2, 1)), device="cpu")
    rf = build_round_fn(lambda v, x, y: v.sum(), FLConfig(n_workers=2, q_frac=0.5),
                        np.zeros((2, 1)), np.zeros((2, 1)), device="cpu")
    assert rf.q_frac == 0.5


# ---------------------------------------------------------------- run level

@pytest.fixture(scope="module")
def fashion_setup():
    x, y, xt, yt = make_image_dataset(ImageDataConfig(n_train=3000, n_test=600, seed=0))
    parts = dirichlet_partition(y, n_workers=20, alpha=0.1, seed=0)
    xp, yp = stack_partitions(x, y, parts)
    v0, apply_fn = tmodels.mlp_fashion(device="cpu")
    jv0, _ = jmodels.mlp_fashion(jax.random.PRNGKey(0))
    v0 = tmodels.from_jax_vector(np.asarray(jv0), "cpu", layout=apply_fn.layout)
    return xp, yp, xt, yt, v0, apply_fn


def _run(fashion_setup, comp, rounds, local_lr=0.05):
    xp, yp, xt, yt, v0, apply_fn = fashion_setup
    cfg = FLConfig(n_workers=20, rounds=rounds, participation=1.0, batch_size=64, lr=0.05,
                   local_lr=local_lr, comp=comp, seed=0, eval_every=rounds)
    return run_fl(v0, apply_fn, cfg, xp, yp, xt, yt, device="cpu")


def test_ef_sparsign_learns_under_heterogeneity(fashion_setup):
    """tests/test_fl.py:58-62 in the port: EF-sparsign, B = 5, Dir(0.1), with
    JAX's v0. 25 rounds instead of 60 keep the CPU run short; the port
    passes 0.55 near round 15 and reaches ~0.8 by round 20."""
    tkernels.reset_launch_counts()
    comp = CompressionConfig(budget=BudgetConfig(value=5.0), server="scaled_sign_ef")
    res = _run(fashion_setup, comp, rounds=25)
    assert res["final_acc"] > 0.55, res["acc"]
    assert len(res["round_s"]) == 25 and res["d"] == 235146
    assert res["uplink_bits_per_round"] < res["d"] * 20
    assert sum(tkernels.launch_counts().values()) == 0  # the CPU ran the plain versions


def test_local_updates_run(fashion_setup):
    comp = CompressionConfig(budget=BudgetConfig(value=1.0), server="scaled_sign_ef",
                             local_steps=3, local_budget=10.0)
    res = _run(fashion_setup, comp, rounds=6, local_lr=0.02)
    assert np.isfinite(res["final_acc"]) and res["final_acc"] > 0.2
    assert torch.isfinite(res["v"]).all()
