"""Elastic participation in the port against the JAX package, on the CPU:
the weighted vote update (kernel 11's plain version), ``ParticipationSpec``,
the counter-hash report mask and the elastic server half of the federated
round. Worker selection comes from a ``torch.Generator`` in the port and from
``jax.random`` in JAX, so the round is compared on its server half with the
sampled workers, their sources and seeds passed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import prng as jprng
from repro.core.algorithm import CompressionConfig as JConfig
from repro.core.budgets import BudgetConfig as JBudget
from repro.dist.collectives import ParticipationSpec as JSpec
from repro.kernels.vote_update.ops import weighted_vote_update_op as j_wvu_op
from repro.kernels.vote_update.ref import vote_update_ref as j_vote_update_ref
from repro.kernels.vote_update.ref import weighted_vote_update_ref as j_wvu_ref
from repro.train import sampling as jsampling
from repro_torch import kernels as tkernels
from repro_torch.core import engine as tengine
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.dist.collectives import ParticipationSpec
from repro_torch.fl.simulation import FLConfig, build_round_fn
from repro_torch.kernels.vote_update.kernel import weighted_vote_update_cuda
from repro_torch.kernels.vote_update.ops import weighted_vote_update_op
from repro_torch.kernels.vote_update.ref import vote_update_ref, weighted_vote_update_ref
from repro_torch.train import sampling as tsampling


def tbits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    if t.dtype == torch.float32:
        return t.view(torch.int32).numpy()
    return t.numpy()


def jbits(x) -> np.ndarray:
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def wvu_inputs(n, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(n).astype(np.float32)
    w[::50] = -0.0
    v = (rng.randint(-6, 7, size=n) * rng.choice([1.0, 0.5, 0.25], size=n)).astype(np.float32)
    v[:5] = [-0.0, 0.0, np.nan, 1.5, -1.5]
    wtot = rng.uniform(0.0, 6.0, size=n).astype(np.float32)
    return w, v, wtot


# ---------------------------------------------------------------- weighted vote update

@pytest.mark.parametrize("wdtype", ["f32", "bf16"])
@pytest.mark.parametrize("per_coord", [False, True])
def test_weighted_vote_update_ref_matches_jax_bitwise(wdtype, per_coord):
    w, v, wtot = wvu_inputs(1031, 3)
    t = wtot if per_coord else np.float32(4.0)
    tw = torch.from_numpy(w).to(torch.bfloat16 if wdtype == "bf16" else torch.float32)
    jw = jnp.asarray(w).astype(jnp.bfloat16 if wdtype == "bf16" else jnp.float32)
    want = j_wvu_ref(jw, jnp.asarray(v), jnp.asarray(t), 0.0123, q_frac=0.3)
    got = weighted_vote_update_ref(tw, torch.from_numpy(v), torch.as_tensor(t), 0.0123, 0.3)
    assert got.dtype == tw.dtype
    np.testing.assert_array_equal(tbits(got), jbits(want))


@pytest.mark.parametrize("wdtype", ["f32", "bf16"])
@pytest.mark.parametrize("per_coord", [False, True])
def test_weighted_vote_update_matches_pallas_interpret(wdtype, per_coord):
    w, v, wtot = wvu_inputs(2000, 5)
    t = wtot if per_coord else np.float32(2.5)
    jw = jnp.asarray(w).astype(jnp.bfloat16 if wdtype == "bf16" else jnp.float32)
    tw = torch.from_numpy(w).to(torch.bfloat16 if wdtype == "bf16" else torch.float32)
    want = j_wvu_op(jw, jnp.asarray(v), jnp.asarray(t), 0.03, q_frac=0.25, interpret=True)
    got = weighted_vote_update_op(tw, torch.from_numpy(v), torch.as_tensor(t), 0.03, q_frac=0.25)
    np.testing.assert_array_equal(tbits(got), jbits(want))


@pytest.mark.parametrize("quorum", [1, 2, 3, 4])
def test_uniform_full_participation_is_the_integer_vote_update(quorum):
    """Weights 1, every worker reporting, W = n_sel = 4 and q_frac = quorum /
    4: the weighted step equals the integer-quorum vote_update bit for bit
    (f32 sums of ternary votes are exact integers and q_frac * 4 is exact)."""
    rng = np.random.RandomState(quorum)
    w = rng.randn(999).astype(np.float32)
    votes = rng.randint(-4, 5, size=999).astype(np.int32)
    q_frac = ParticipationSpec().resolve_q_frac(quorum, 4)
    assert q_frac == JSpec().resolve_q_frac(quorum, 4)
    weighted = weighted_vote_update_ref(torch.from_numpy(w), torch.from_numpy(votes).float(),
                                        torch.tensor(4.0), 0.05, q_frac)
    legacy = vote_update_ref(torch.from_numpy(w), torch.from_numpy(votes), 0.05, quorum)
    np.testing.assert_array_equal(tbits(weighted), tbits(legacy))
    np.testing.assert_array_equal(tbits(legacy),
                                  jbits(j_vote_update_ref(jnp.asarray(w), jnp.asarray(votes),
                                                          0.05, quorum)))


def test_weighted_wrapper_refuses_cpu_and_counts_no_launch():
    w = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        weighted_vote_update_cuda(w, w, torch.ones(1), 0.1, 0.5)
    tkernels.reset_launch_counts()
    weighted_vote_update_op(w, w, 1.0, 0.1, q_frac=0.5)
    assert tkernels.launch_counts()["weighted_vote_update"] == 0


# ---------------------------------------------------------------- participation

def test_participation_spec_validates_like_jax():
    for bad in (dict(weights=()), dict(weights=(1.0, 0.0)), dict(weights=(1.0, float("inf"))),
                dict(q_frac=0.0), dict(q_frac=1.5), dict(dropout=1.0), dict(dropout=-0.1)):
        with pytest.raises(ValueError):
            JSpec(**bad)
        with pytest.raises(ValueError):
            ParticipationSpec(**bad)
    spec, jspec = ParticipationSpec(weights=(1, 2.5, 3)), JSpec(weights=(1, 2.5, 3))
    assert spec.weights == jspec.weights == (1.0, 2.5, 3.0) and not spec.is_uniform
    np.testing.assert_array_equal(spec.weights_array(3).numpy(), np.asarray(jspec.weights_array(3)))
    assert float(spec.weight_of(1, 3)) == float(jspec.weight_of(1, 3)) == 2.5
    with pytest.raises(ValueError, match="cover 3 workers"):
        spec.weights_array(4)
    assert ParticipationSpec().weights_array(2).tolist() == [1.0, 1.0]
    for q in (1, 3, 8):
        assert ParticipationSpec().resolve_q_frac(q, 8) == JSpec().resolve_q_frac(q, 8)
    assert ParticipationSpec(q_frac=0.3).resolve_q_frac(1, 8) == 0.3
    with pytest.raises(ValueError, match="quorum"):
        ParticipationSpec().resolve_q_frac(9, 8)


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_report_and_participation_masks_match_jax_bitwise(seed):
    widx = np.arange(0, 4096, 3, dtype=np.int32)
    for r in (0, 5, 2**31 + 17):
        for rate in (0.0, 0.1, 0.5, 0.97):
            want = jax.vmap(lambda w: jsampling.report_mask(jnp.uint32(seed), np.uint32(r), w,
                                                            rate))(jnp.asarray(widx))
            got = tsampling.report_mask(seed, r, torch.from_numpy(widx), rate)
            np.testing.assert_array_equal(got.numpy(), np.broadcast_to(np.asarray(want), widx.shape))
            want = jax.vmap(lambda w: jsampling.participation_mask(
                jnp.uint32(seed), np.uint32(r), w, 1.0 - rate))(jnp.asarray(widx))
            got = tsampling.participation_mask(seed, r, torch.from_numpy(widx), 1.0 - rate)
            np.testing.assert_array_equal(got.numpy(), np.broadcast_to(np.asarray(want), widx.shape))
        assert int(tsampling.round_seed(seed, r)) == int(jsampling.round_seed(jnp.uint32(seed),
                                                                              np.uint32(r)))


# ---------------------------------------------------------------- the elastic server half

M, SEL, D = 10, (7, 2, 9, 4, 0), 1337


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    v = rng.randn(D).astype(np.float32)
    srcs = (rng.randn(len(SEL), D) * rng.uniform(0.2, 2.0, size=(len(SEL), 1))).astype(np.float32)
    srcs[:, ::40] = 0.0
    ef = np.zeros(D, np.float32)
    seeds = (jprng.fold_seed(jnp.uint32(11), 0x5EED)
             + jnp.asarray(np.array(SEL, np.uint32)) * jnp.uint32(0x9E3779B9)
             + jnp.uint32(3) * jnp.uint32(0x85EBCA6B))
    return v, srcs, ef, np.asarray(seeds)


def _jax_elastic_server(v, ef, srcs, seeds, comp, cfg, round_idx):
    """fl/simulation.py:130-164 of the JAX package on injected sources."""
    spec = JSpec(weights=cfg.worker_weights, q_frac=cfg.q_frac, dropout=cfg.dropout)
    server_rule = comp.server if jengine.is_vote_server(comp) else "mean"
    n_sel = len(SEL)
    q_frac = spec.resolve_q_frac(cfg.quorum, n_sel)
    sel = jnp.asarray(np.array(SEL, np.int32))
    rmask = jax.vmap(lambda w: jsampling.report_mask(jnp.uint32(cfg.seed), jnp.int32(round_idx),
                                                     w, spec.dropout))(sel)
    w_eff = spec.weights_array(cfg.n_workers)[sel] * rmask.astype(jnp.float32)
    jsrcs = jnp.asarray(srcs)
    shared = None
    if jengine.needs_shared_linf(comp):
        mags = jnp.max(jnp.abs(jsrcs), axis=1)
        shared = jnp.max(jnp.where(rmask, mags, 0.0))

    def msg(s, sd):
        m = jengine.compress_leaf(s, comp, sd, shared_linf=shared, backend="jnp")
        return m.values.astype(jnp.float32) * m.scale, jnp.sum(jnp.abs(jnp.sign(m.values)))

    dec, nnz = jax.vmap(msg)(jsrcs, jnp.asarray(seeds))
    wv = jnp.sum(dec * w_eff[:, None], axis=0)
    wabs = jnp.sum(jnp.abs(dec * w_eff[:, None]), axis=0)  # the sum's rounding scale
    wtot = jnp.sum(w_eff)
    if server_rule == "majority_vote":
        v2, ef2 = jengine.server_apply(jnp.asarray(v), wv, comp, lr=cfg.lr, ef=jnp.asarray(ef),
                                       part_total=wtot, q_frac=q_frac, backend="jnp")
    else:
        v2, ef2 = jengine.server_apply(jnp.asarray(v), wv, comp, lr=cfg.lr, ef=jnp.asarray(ef),
                                       n_sel=wtot, server="mean", backend="jnp")
    return v2, ef2, jnp.mean(nnz * rmask.astype(jnp.float32)), wv, wtot, np.asarray(wabs)


def _port_round_fn(comp, **elastic):
    cfg = FLConfig(n_workers=M, participation=len(SEL) / M, lr=0.03, comp=comp, seed=4,
                   **elastic)
    rf = build_round_fn(lambda v, x, y: v.sum(), cfg, np.zeros((M, 4, 2), np.float32),
                        np.zeros((M, 4), np.int32), device="cpu")
    return cfg, rf


INT_WEIGHTS = tuple(float(x) for x in range(1, M + 1))
FRAC_WEIGHTS = tuple(float(x) for x in np.random.RandomState(1).uniform(0.1, 3.0, size=M))


@pytest.mark.parametrize("name,server", [("sign", "majority_vote"), ("sparsign", "majority_vote"),
                                         ("terngrad", "mean"), ("scaled_sign", "mean")])
@pytest.mark.parametrize("weights", ["int", "frac"])
def test_elastic_server_half_matches_jax(name, server, weights):
    """With integer weights and ternary messages the weighted vote is exact,
    so the vote and the whole step are bit for bit. With fractional weights
    the vote sum runs in another order in XLA and in torch: the port's vote is
    held to 1e-6 of sum(|dec * w_eff|), the rounding scale of either order,
    and its step bit for bit wherever |v| is not within that rounding of the
    deadband q_frac * W; the server step given the same vote and W is bit
    for bit everywhere."""
    w = INT_WEIGHTS if weights == "int" else FRAC_WEIGHTS
    elastic = dict(worker_weights=w, q_frac=0.4, dropout=0.3)
    jcomp = JConfig(compressor=name, budget=JBudget(value=1.5), server=server)
    tcomp = CompressionConfig(compressor=name, budget=BudgetConfig(value=1.5), server=server)
    cfg, rf = _port_round_fn(tcomp, **elastic)
    v, srcs, ef, seeds = _inputs()
    for round_idx in (3, 4):
        jv, jef, jnnz, jwv, jwtot, jwabs = _jax_elastic_server(v, ef, srcs, seeds, jcomp, cfg,
                                                               round_idx)
        jwv, jwtot = np.asarray(jwv), np.asarray(jwtot)
        sel = torch.tensor(SEL)
        tsrcs, tseeds = torch.from_numpy(srcs), torch.from_numpy(seeds.astype(np.int64))
        tv, tef, tnnz = rf.server(torch.from_numpy(v), torch.from_numpy(ef), tsrcs, tseeds,
                                  sel, round_idx)
        twv, twtot, vnnz = rf.weighted_vote(tsrcs, tseeds, sel, round_idx)
        rmask, _ = rf.reporting(sel, round_idx)
        assert 0 < int(rmask.sum()) < len(SEL)  # some reports were dropped
        assert float(tnnz) == float(vnnz) == pytest.approx(float(jnnz), rel=1e-6)
        assert float(twtot) == pytest.approx(float(jwtot), rel=1e-6)
        exact = weights == "int" and name in ("sign", "sparsign")
        if exact:
            np.testing.assert_array_equal(tbits(twv), jbits(jwv))
            np.testing.assert_array_equal(tbits(tv), jbits(jv))
        else:
            tol = 1e-6 * jwabs
            assert np.all(np.abs(twv.numpy() - jwv) <= tol)
        if not exact and server == "majority_vote":
            # the same weighted vote and W into the port's server step
            sv, _ = tengine.server_apply(torch.from_numpy(v), torch.tensor(jwv), tcomp,
                                         lr=cfg.lr, part_total=torch.tensor(jwtot), q_frac=0.4)
            np.testing.assert_array_equal(tbits(sv), jbits(jv))
            # the port's own step, away from the deadband's rounding
            clear = np.abs(np.abs(jwv) - np.float32(0.4) * jwtot) > tol + 1e-6 * float(jwtot)
            assert clear.mean() > 0.99
            np.testing.assert_array_equal(tbits(tv)[clear], jbits(jv)[clear])
        elif not exact:
            sv, _ = tengine.server_apply(torch.from_numpy(v), torch.tensor(jwv), tcomp,
                                         lr=cfg.lr, n_sel=torch.tensor(jwtot), server="mean")
            np.testing.assert_array_equal(tbits(sv), jbits(jv))
            # scales are norms summed in another order: the whole step to rtol
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(tbits(tef), jbits(jef))


def test_elastic_needs_q_frac_and_refuses_ef_at_apply():
    p, votes = torch.zeros(5), torch.ones(5)
    with pytest.raises(ValueError, match="q_frac"):
        tengine.server_apply(p, votes, CompressionConfig(), lr=0.1, part_total=3.0)
    with pytest.raises(ValueError, match="scaled_sign_ef"):
        tengine.server_apply(p, votes, CompressionConfig(server="scaled_sign_ef"), lr=0.1,
                             ef=p, n_sel=1.0, part_total=3.0)
    cfg, rf = _port_round_fn(CompressionConfig(compressor="sign"), q_frac=0.5)
    with pytest.raises(ValueError, match="sel"):
        rf.server(p, p, torch.ones(len(SEL), 5), torch.arange(len(SEL)))
    with pytest.raises(ValueError, match="n_workers"):
        _port_round_fn(CompressionConfig(compressor="sign"), worker_weights=(1.0, 2.0))
