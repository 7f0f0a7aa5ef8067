"""The paper's theory and its run-level claims in the port, on the CPU: the
closed forms of ``core.theory`` against the JAX package's, the Monte Carlo
under the Thm. 1 bound, and the claims of tests/test_fl.py reproduced by the
port's own runs (Rosenbrock, Fig. 1; deterministic sign oscillating where
EF-sparsign climbs, §6.2). The runs draw workers and batches from a
``torch.Generator``, not ``jax.random``, so they are held to the claims, not
to the JAX runs' numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import theory as jtheory
from repro.fl import models as jmodels
from repro_torch.core import theory
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.synthetic import ImageDataConfig, make_image_dataset
from repro_torch.fl import grid, rosenbrock
from repro_torch.fl import models as tmodels
from repro_torch.fl.simulation import FLConfig, run_fl, stack_partitions


def hetero_u(m=100, n_neg=80, seed=0) -> np.ndarray:
    """tests/test_theory.py's worker scalars: 80 small wrong signs, 20 large right ones."""
    rng = np.random.RandomState(seed)
    u = np.concatenate([-rng.uniform(0.005, 0.015, n_neg), rng.uniform(0.05, 0.15, m - n_neg)])
    rng.shuffle(u)
    return u.astype(np.float32)


# ---------------------------------------------------------------- theory

@pytest.mark.parametrize("p_select", [1.0, 0.5])
@pytest.mark.parametrize("budget", [0.5, 5.0])
def test_closed_forms_match_jax(budget, p_select):
    u = hetero_u()
    tu, ju = torch.from_numpy(u), jnp.asarray(u)
    for got, want in zip(theory.sparsign_pq(tu, budget, p_select),
                         jtheory.sparsign_pq(ju, budget, p_select)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for got, want in zip(theory.deterministic_sign_pq(tu, p_select),
                         jtheory.deterministic_sign_pq(ju, p_select)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    p, q = (float(x) for x in jtheory.sparsign_pq(ju, budget, p_select))
    np.testing.assert_allclose(float(theory.wrong_aggregation_bound(p, q, 100)),
                               float(jtheory.wrong_aggregation_bound(p, q, 100)), rtol=1e-6)
    # kappa = base^M with base built from sums of 100 terms taken in another
    # order: the rounding lies in the base, which the M-th root recovers (the
    # power itself multiplies the base's relative error by M = 100)
    got, want = float(theory.kappa(tu, budget, p_select)), float(jtheory.kappa(ju, budget, p_select))
    np.testing.assert_allclose(got ** 0.01, want ** 0.01, rtol=1e-6)


@pytest.mark.parametrize("budget", [0.5, 2.0, 5.0])
def test_monte_carlo_within_theorem1_bound(budget):
    """tests/test_theory.py's check on the port's Monte Carlo: the empirical
    wrong-aggregation rate stays under the Thm. 1 bound (plus 0.02 of Monte
    Carlo noise at 4000 trials), and deterministic sign's premise fails."""
    u = torch.from_numpy(hetero_u())
    p_bar, q_bar = theory.sparsign_pq(u, budget)
    assert float(q_bar) > float(p_bar)
    bound = float(theory.wrong_aggregation_bound(p_bar, q_bar, 100))
    mc = float(theory.monte_carlo_wrong_aggregation(torch.Generator().manual_seed(0), u, budget,
                                                    n_trials=4000))
    assert mc <= bound + 0.02, (mc, bound)
    sampled = float(theory.monte_carlo_wrong_aggregation(
        torch.Generator().manual_seed(1), u, budget, n_trials=4000, n_sampled=10))
    assert sampled >= mc - 0.02   # fewer voters, no better (Remark 3)
    p_s, q_s = theory.deterministic_sign_pq(u)
    assert float(p_s) > float(q_s)


# ---------------------------------------------------------------- Rosenbrock (Fig. 1)

def test_rosenbrock_paper_claims():
    """tests/test_fl.py's Fig. 1 claims in the port: sign's wrong-aggregation
    rate above 0.9 and no progress; sparsign's below 0.5, and F falls."""
    r_sign = rosenbrock.run("sign", rounds=120, n_sel=100, lr=1e-3, device="cpu")
    r_sp = rosenbrock.run("sparsign", budget=0.01, rounds=120, n_sel=100, lr=1e-3, device="cpu")
    assert r_sign.wrong_agg.mean() > 0.9
    assert r_sp.wrong_agg.mean() < 0.5
    assert r_sp.values[-1] < r_sp.values[0]
    assert r_sp.values[-1] < r_sign.values[-1]
    np.testing.assert_allclose(rosenbrock.make_heterogeneity(100, 80, seed=3).sum(), 1.0)


def test_rosenbrock_worker_sampling_monotone():
    """Fig. 2 / Remark 3: more sampled workers, fewer wrong aggregations."""
    wrongs = [rosenbrock.run("sparsign", budget=0.01, rounds=80, n_sel=ns, lr=2e-4,
                             device="cpu").wrong_agg.mean() for ns in (5, 50)]
    assert wrongs[1] < wrongs[0]


# ---------------------------------------------------------------- the §6 grid

def test_grid_is_the_benchmarks_grid():
    """fl/grid.py is the port's copy of benchmarks/common.py's ALGORITHMS and
    of the Table 1-2 protocols."""
    from benchmarks.common import ALGORITHMS as JALGOS
    assert list(grid.ALGORITHMS) == list(JALGOS)
    for name, comp in grid.ALGORITHMS.items():
        j = JALGOS[name]
        assert (comp.compressor, comp.server, comp.budget.kind, comp.budget.value,
                comp.local_steps) == (j.compressor, j.server, j.budget.kind, j.budget.value,
                                      j.local_steps)
    t1, t2 = grid.TABLE1, grid.TABLE2
    assert (t1.n_workers, t1.alpha, t1.batch_size, t1.lr, t1.participation) == (50, 0.1, 64, 0.05, 1.0)
    assert (t2.n_workers, t2.alpha, t2.batch_size, t2.lr, t2.participation) == (20, 0.5, 32, 0.03, 0.2)
    cfg = t2.fl_config(grid.ALGORITHMS["terngrad"], rounds=3)
    assert isinstance(cfg, FLConfig) and cfg.rounds == 3 and cfg.n_workers == 20


# ---------------------------------------------------------------- §6.2 at test scale

@pytest.fixture(scope="module")
def fashion_setup():
    x, y, xt, yt = make_image_dataset(ImageDataConfig(n_train=3000, n_test=600, seed=0))
    parts = dirichlet_partition(y, n_workers=20, alpha=0.1, seed=0)
    xp, yp = stack_partitions(x, y, parts)
    _, apply_fn = tmodels.mlp_fashion(device="cpu")
    jv0, _ = jmodels.mlp_fashion(jax.random.PRNGKey(0))
    v0 = tmodels.from_jax_vector(np.asarray(jv0), "cpu", layout=apply_fn.layout)
    return xp, yp, xt, yt, v0, apply_fn


def test_sparsign_stable_where_sign_oscillates(fashion_setup):
    """tests/test_fl.py's §6.2 claim in the port: under Dir(0.1) EF-sparsign's
    accuracy curve is (near-)monotone, deterministic signSGD's is not."""
    xp, yp, xt, yt, v0, apply_fn = fashion_setup

    def run(comp):
        cfg = FLConfig(n_workers=20, rounds=60, batch_size=64, lr=0.05, comp=comp, seed=0,
                       eval_every=10)
        return run_fl(v0, apply_fn, cfg, xp, yp, xt, yt, device="cpu")

    sp = run(CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=5.0),
                               server="scaled_sign_ef"))
    sg = run(grid.ALGORITHMS["signSGD"])
    sp_curve = np.array([a for _, a in sp["acc"]])
    sg_curve = np.array([a for _, a in sg["acc"]])
    sp_drawdown = float(np.max(np.maximum.accumulate(sp_curve) - sp_curve))
    sg_drawdown = float(np.max(np.maximum.accumulate(sg_curve) - sg_curve))
    assert sp_drawdown <= 0.05, sp["acc"]
    assert sg_drawdown > sp_drawdown, (sg["acc"], sp["acc"])
    assert sp["final_acc"] > 0.55
