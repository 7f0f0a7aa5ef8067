"""The tensor-parallel 'model' axis of the port's simple trainer, on the CPU.

(a) The model at T = 2 (``models.tensor_parallel``), float32, the smoke
    configs of the five dense families: loss and reassembled gradients
    against T = 1, and for qwen1.5-4b and granite-34b (its single kv head
    cut inside the head) against JAX's ``Model.loss`` / ``jax.grad``.
(b) The (4, 2) round with injected per-worker gradients: each model rank
    compresses its slice with the whole leaf's counters and statistics,
    exchanges over the workers and updates its slice; reassembled, the
    parameters equal JAX's engine on whole leaves bit for bit (``fixed``
    sparsign on psum, hier and allgather_packed; qsgd8 on pack8 and the
    decoded psum), ``scaled_sign_ef`` to rtol 1e-6, the L2 budget within a
    flip bound; wire bytes are the slice ledger.
(c) Two gloo processes equal one: (2 data x 2 model) whole workers a
    process, and (1 x 2) a model rank a process.
(d) Checkpoints at T = 2 are the T = 1 files byte for byte and restore
    across T; the launcher's ``--host-model 2``; every path not ported
    under T > 1 raises (the bucketed uplink, the ring and subgroups:
    ``tests/test_torch_tp_bucketed.py``).
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.core import engine as jengine
from repro.core import prng as jprng
from repro.core.algorithm import CompressionConfig as JConfig
from repro.core.budgets import BudgetConfig as JBudget
from repro.models.model import Model as JModel
from repro.train import sampling as jsampling
from repro_torch.analysis.drivers import tp_slice_ledger
from repro_torch.configs.registry import get_config
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.data.synthetic import LMStreamConfig, lm_batch
from repro_torch.dist.collectives import ModelGroup, ParticipationSpec
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import tensor_parallel as tpl
from repro_torch.models.model import Model, ShapeDtype, params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAD_RTOL = 5e-5   # test_torch_lm's: of each leaf's norm
LOSS_RTOL = 1e-6
# gemma3's smoke model is 8 layers deep: its float32 gradients lie 1e-4 to
# 4e-4 of a leaf's norm from a float64 run (test_torch_window), and the T = 2
# split's other sums land 7.5e-5 from T = 1, inside that noise; held as
# test_torch_window holds it
GRAD_RTOL_DEEP = {"gemma3-27b": 1e-3}
M, T = 4, 2
#: the noisy_sign flip bound against JAX (tests/test_torch_ternary.py): at most 1
#: symbol in 10^5
NOISY_FLIP_RATE = 1e-5
FAMILIES = ["qwen1.5-4b", "qwen2.5-32b", "granite-34b", "gemma3-27b", "hubert-xlarge"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def f32bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _batch(cfg, b, s, seed):
    batch = lm_batch(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                                    seed=seed), 0)
    if cfg.input_kind != "tokens":
        batch["inputs"] = (np.random.RandomState(seed).randn(b, s, cfg.d_model)
                           .astype(np.float32) * 0.3)
    batch["labels"][0, -1] = -1
    return batch


def _loss_and_grads(loss_fn, params, batch):
    leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves),
                   {k: torch.from_numpy(v) for k, v in batch.items()})[0]
    return float(loss.detach()), [g.detach() for g in torch.autograd.grad(loss, leaves)]


# ------------------------------------------------------------ (a) the model

@pytest.mark.parametrize("arch", FAMILIES)
def test_tp_model_matches_t1(arch):
    """Loss and gradients of the T = 2 model (both ranks in this process),
    reassembled, against the T = 1 model from the same weights; 24 tokens
    cross the attention and loss chunks (16) with a ragged last chunk and a
    masked label."""
    model = Model(get_config(arch, smoke=True))
    params = model.init(0, "cpu")
    batch = _batch(model.cfg, 2, 24, seed=1)
    l1, g1 = _loss_and_grads(model.loss, params, batch)
    mg = ModelGroup(T)
    tpm = model.tensor_parallel(mg)
    l2, g2 = _loss_and_grads(tpm.loss, tpl.shard_tree(params, tpm.placements, mg), batch)
    g2 = tree_leaves(tpl.gather_tree(tree_unflatten(params, g2), tpm.placements, mg))
    np.testing.assert_allclose(l2, l1, rtol=LOSS_RTOL)
    rtol = GRAD_RTOL_DEEP.get(arch, GRAD_RTOL)
    for a, b in zip(g1, g2):
        assert a.shape == b.shape
        assert float((a - b).norm()) <= rtol * float(a.norm()) + 1e-12
    assert any(pl.sharded for pl in tree_leaves(tpm.placements))


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "granite-34b"])
def test_tp_model_matches_jax(arch):
    """The T = 2 model from JAX's weights against JAX's Model.loss and
    jax.grad (granite-34b's kv leaves are cut inside its one head)."""
    jm = JModel(jget_config(arch, smoke=True))
    jp = jm.init(jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    model = Model(get_config(arch, smoke=True))
    batch = _batch(model.cfg, 2, 24, seed=24)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, bt: jm.loss(p, bt)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    mg = ModelGroup(T)
    tpm = model.tensor_parallel(mg)
    if arch == "granite-34b":
        assert not tpm.kv_split and tpm.placements["blocks"][0]["wk"].sharded
    l2, g2 = _loss_and_grads(tpm.loss, tpl.shard_tree(params, tpm.placements, mg), batch)
    g2 = tree_leaves(tpl.gather_tree(tree_unflatten(params, g2), tpm.placements, mg))
    np.testing.assert_allclose(l2, float(jl), rtol=LOSS_RTOL)
    for j, t in zip(jax.tree_util.tree_leaves(jg), g2):
        j, t = np.asarray(j), t.numpy()
        assert np.linalg.norm(t - j) <= GRAD_RTOL * np.linalg.norm(j) + 1e-12


# ------------------------------------------------------ (b) the (4, 2) round

F32 = torch.float32
TP_SHAPES = {"blocks": ({"b1": ShapeDtype((2, 33), F32), "ln1": ShapeDtype((2, 40), F32),
                         "w_up": ShapeDtype((2, 40, 96), F32),
                         "wo": ShapeDtype((2, 64, 40), F32)},),
             "embed": ShapeDtype((64, 40), F32), "final_norm": ShapeDtype((40,), F32),
             "lm_head": ShapeDtype((40, 64), F32)}
TP_LOGICAL = {"blocks": ({"b1": (None, "ff"), "ln1": (None, None),
                          "w_up": (None, None, "ff"), "wo": (None, "heads", None)},),
              "embed": ("vocab", None), "final_norm": (None,), "lm_head": (None, "vocab")}


class InjectedTPModel:
    """loss = sum_i <p_i, g_i> with the worker's gradients g_i from the batch,
    and its tensor-parallel form on the TP layout: each rank's gradient is
    its slice of g_i exactly. b1's 33 columns do not split, so it stays
    replicated; w_up is cut on its last axis (a strided slice), wo on a
    middle one, embed and lm_head on the vocabulary."""

    def param_shapes(self):
        return TP_SHAPES

    def param_logical_axes(self):
        return TP_LOGICAL

    def loss(self, params, batch):
        total = sum(torch.sum(p * batch[f"g{i}"][0]) for i, p in enumerate(tree_leaves(params)))
        return total, {"loss": total}

    def tensor_parallel(self, mg):
        return _InjectedTP(self, mg)


class _InjectedTP:
    def __init__(self, model, mg):
        self.mg = mg
        self.placements = tpl.placements_for(model, mg.size)

    def loss(self, params, batch):
        total = sum(torch.sum(p * tpl.shard_leaf(batch[f"g{i}"][0], pl, self.mg))
                    for i, (p, pl) in enumerate(zip(tree_leaves(params),
                                                    tree_leaves(self.placements))))
        return total, {"loss": total}


def _tp_injected(seed, exact=False):
    """Parameters and per-worker gradients (numpy); ``exact``: multiples of
    1/8 in [-2, 2], so every sum of squares is exact in any order."""
    rng = np.random.RandomState(seed)
    shapes = [s.shape for s in tree_leaves(TP_SHAPES)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    per = []
    for s in shapes:
        if exact:
            g = rng.randint(-16, 17, (M,) + s).astype(np.float32) / 8
        else:
            g = rng.randn(M, *s).astype(np.float32) * 0.3
        g.reshape(M, -1)[:, ::53] = 0.0
        per.append(g)
    return params, per, {f"g{i}": g for i, g in enumerate(per)}


def _state_of(leaves, server):
    return init_state(params_from_numpy(tree_unflatten(TP_SHAPES, list(leaves))),
                      server=server, seed=11)


def jax_round(params, per, jc, *, seed, step, lr, efs=None, impl="psum", part=None):
    """One round of the trainer on whole leaves from the JAX package's
    parts, worker by worker, as JAX's ``step_simple`` composes them: seeds
    and masks (``sampling``; with ``part``, a ParticipationSpec, the report
    mask and the effective weights), the shared L-inf max where the row
    shares it, the engine's compress_leaf (jnp backend), the messages summed
    in worker order (int8 votes; weighted float votes and W; or decoded
    floats for a decoded or pack8 row) and server_apply."""
    rseed = jsampling.round_seed(jnp.uint32(seed), jnp.int32(step))
    wseeds = [jprng.fold_seed(rseed, 0x5EED) + jnp.uint32(w) * jnp.uint32(0x9E3779B9)
              for w in range(M)]
    mask = [jsampling.participation_mask(rseed, jnp.int32(step), jnp.uint32(w),
                                         jc.worker_sample_fraction) for w in range(M)]
    w_eff = None
    if part is not None:
        mask = [m & jsampling.report_mask(rseed, jnp.int32(step), jnp.uint32(w), part.dropout)
                for w, m in enumerate(mask)]
        w_eff = [jnp.float32(part.weights[w]) * jnp.asarray(m, jnp.float32)
                 for w, m in enumerate(mask)]
        q_frac = part.resolve_q_frac(1, M)
    n_sel = sum(jnp.asarray(m, jnp.float32) for m in mask)
    mode = jengine.wire_mode(jc, vote_impl=impl)
    out, out_ef = [], []
    for i, p in enumerate(params):
        shared = None
        if jengine.needs_shared_linf(jc):
            shared = max(jnp.where(mask[w], jnp.max(jnp.abs(jnp.asarray(per[i][w]))), 0.0)
                         for w in range(M))
        msgs = [jengine.compress_leaf(jnp.asarray(per[i][w]), jc, jprng.fold_seed(wseeds[w], i),
                                      backend="jnp", shared_linf=shared) for w in range(M)]
        ef = None if efs is None else jnp.asarray(efs[i])
        if mode in ("decoded", "pack8"):
            total = None
            for w, msg in enumerate(msgs):
                sc = msg.scale * w_eff[w] if part is not None else msg.scale
                dec = jnp.where(mask[w], msg.values.astype(jnp.float32) * sc, 0.0)
                total = dec if total is None else total + dec
            divisor = sum(w_eff) if part is not None else n_sel
            new, ef = jengine.server_apply(jnp.asarray(p), total, jc, lr=lr, n_sel=divisor,
                                           server="mean", backend="jnp")
        elif part is not None:
            total = None
            for w, m in enumerate(msgs):
                wv = jnp.where(mask[w], m.values, 0).astype(jnp.float32) * w_eff[w]
                total = wv if total is None else total + wv
            new, ef = jengine.server_apply(jnp.asarray(p), total, jc, lr=lr,
                                           part_total=sum(w_eff), q_frac=q_frac, backend="jnp")
        else:
            votes = sum(jnp.where(mask[w], m.values, 0).astype(jnp.int32)
                        for w, m in enumerate(msgs)).astype(jnp.int8)
            if mode == "scaled_votes":
                new, ef = jengine.server_apply(jnp.asarray(p), votes, jc, lr=lr, n_sel=n_sel,
                                               server="mean", scale=msgs[-1].scale,
                                               backend="jnp")
            else:
                new, ef = jengine.server_apply(jnp.asarray(p), votes, jc, lr=lr, n_sel=n_sel,
                                               ef=ef, backend="jnp")
        out.append(np.asarray(new))
        out_ef.append(None if ef is None else np.asarray(ef))
    return out, out_ef


MESH = ((M, T), ("data", "model"))
HIER_MESH = ((2, 2, T), ("pod", "data", "model"))
#: dyadic weights: every order of the weighted sums is exact
ELASTIC = ParticipationSpec(weights=(1.5, 0.5, 2.0, 1.0), dropout=0.25)


def _tp_step(tcomp, impl, mesh=MESH, **kw):
    return build_train_step(InjectedTPModel(), TrainStepConfig(
        compression=tcomp, lr=LrSchedule(base=0.05), vote_impl=impl, **kw), make_mesh(*mesh))


def _t1_step(tcomp, impl, **kw):
    mesh = ((2, 2), ("pod", "data")) if impl == "hier" else ((M,), ("data",))
    return build_train_step(InjectedTPModel(), TrainStepConfig(
        compression=tcomp, lr=LrSchedule(base=0.05), vote_impl=impl, **kw), make_mesh(*mesh))


#: name: (compressor, server, vote_impl, options). Options: ``budget``
#: (default: 2.0 for the sparsign rows, else 1.0), ``kind`` (the budget's),
#: ``exact`` (gradients in multiples of 1/8: every sum of squares or of |g|
#: exact in any order), ``golomb_p``, ``part`` (a ParticipationSpec) and
#: ``flips`` (noisy_sign: the Box-Muller flip bound against JAX, the round
#: held bit for bit against the port's T = 1 instead)
ROUND_CASES = {
    "sparsign-psum": ("sparsign", "majority_vote", "psum", {}),
    "sparsign-hier": ("sparsign", "majority_vote", "hier", {}),
    "sparsign-packed": ("sparsign", "majority_vote", "allgather_packed", {}),
    "qsgd8-pack8": ("qsgd8", "mean", "allgather_packed", {"exact": True}),
    "qsgd8-decoded-psum": ("qsgd8", "mean", "psum", {"exact": True}),
    "sign-psum": ("sign", "majority_vote", "psum", {}),
    "sign-hier": ("sign", "majority_vote", "hier", {}),
    "noisy_sign-psum": ("noisy_sign", "majority_vote", "psum", {"budget": 0.3, "flips": True}),
    "noisy_sign-hier": ("noisy_sign", "majority_vote", "hier", {"budget": 0.3, "flips": True}),
    "terngrad-psum": ("terngrad", "mean", "psum", {}),
    "terngrad-hier": ("terngrad", "mean", "hier", {}),
    "qsgd_1bit_linf-packed": ("qsgd_1bit_linf", "mean", "allgather_packed", {}),
    "scaled_sign-packed": ("scaled_sign", "mean", "allgather_packed", {"exact": True}),
    "linf_share-psum": ("sparsign", "majority_vote", "psum", {"kind": "linf_share"}),
    "golomb-packed": ("sparsign_golomb", "majority_vote", "allgather_packed",
                      {"budget": 0.2, "golomb_p": 0.1}),
    "elastic-packed": ("sparsign", "majority_vote", "allgather_packed", {"part": ELASTIC}),
    "elastic-psum": ("sparsign", "majority_vote", "psum", {"part": ELASTIC}),
}


def _configs(comp_name, server, opts):
    budget = opts.get("budget", 2.0 if comp_name.startswith("sparsign") else 1.0)
    kind = opts.get("kind", "fixed")
    return (JConfig(compressor=comp_name, budget=JBudget(kind=kind, value=budget), server=server),
            CompressionConfig(compressor=comp_name, budget=BudgetConfig(kind=kind, value=budget),
                              server=server))


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_tp_round_matches_jax_on_whole_leaves(case):
    """Two (4, 2) rounds with injected gradients: the slices, reassembled,
    equal JAX's whole-leaf round bit for bit wherever the whole leaf's
    statistic is exact (a fixed budget, linf_share, TernGrad, 1-bit L-inf
    QSGD, sign, the elastic weights; scaled sign and qsgd8 on gradients whose
    sums are exact); noisy_sign within the Box-Muller flip bound of JAX and
    bit for bit against the port's T = 1. Wire bytes are the slice ledger
    (each device's slices, replicated leaves whole); the golomb wire drops
    no nonzero."""
    comp_name, server, impl, opts = ROUND_CASES[case]
    jc, tc = _configs(comp_name, server, opts)
    part = opts.get("part")
    kw = {k: opts[k] for k in ("golomb_p",) if k in opts}
    if part is not None:
        kw["participation"] = part
    step = _tp_step(tc, impl, HIER_MESH if impl == "hier" else MESH, **kw)
    t1 = _t1_step(tc, impl, **kw) if opts.get("flips") else None
    exact = opts.get("exact", False)
    params, _, _ = _tp_injected(0, exact)
    state = step.shard_state(_state_of(params, server))
    s1 = _state_of(params, server) if t1 is not None else None
    differ = 0
    for r in range(2):
        _, per, batch = _tp_injected(r + 1, exact)
        want, _ = jax_round(params, per, jc, seed=11, step=r, lr=np.float32(0.05), impl=impl,
                            part=part)
        state, metrics = step(state, batch)
        got = [t.numpy().copy() for t in tree_leaves(step.whole_state(state).params)]
        if t1 is None:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(f32bits(a), f32bits(b))
        else:
            s1, _ = t1(s1, batch)
            for a, b in zip(got, tree_leaves(s1.params)):
                np.testing.assert_array_equal(f32bits(a), f32bits(b.numpy()))
            differ += sum(int((f32bits(a) != f32bits(b)).sum()) for a, b in zip(got, want))
        assert any((a != p).any() for a, p in zip(got, params))
        assert float(metrics["wire_bytes_per_device"]) == np.float32(
            tp_slice_ledger(step, InjectedTPModel()))
        if "nnz_dropped" in metrics:
            assert float(metrics["nnz_dropped"]) == 0.0
        params = want if t1 is None else got
    if t1 is not None:
        size = sum(a.size for a in got)
        print(f"{case} at (4, 2): {differ} of {2 * size} coordinates differ from JAX")
        assert differ <= max(1, int(np.ceil(NOISY_FLIP_RATE * 2 * M * size)))


def test_tp_round_scaled_sign_ef_against_jax():
    """scaled_sign_ef: the server's L1 is the ordered sum of the slices'
    partials, which for a strided slice cannot be the whole leaf's own sum
    order; held to rtol 1e-6 as the port's EF step is held against JAX's,
    the votes bit for bit (the same coordinates move), the residual to 1e-6
    of its largest magnitude, and the count of coordinates that differ
    printed."""
    jc = JConfig(compressor="sparsign", budget=JBudget(value=2.0), server="scaled_sign_ef")
    tc = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                           server="scaled_sign_ef")
    step = _tp_step(tc, "psum")
    params, _, _ = _tp_injected(0)
    efs = [np.zeros_like(p) for p in params]
    state = step.shard_state(_state_of(params, "scaled_sign_ef"))
    differ = total = 0
    for r in range(2):
        _, per, batch = _tp_injected(r + 1)
        want, want_ef = jax_round(params, per, jc, seed=11, step=r, lr=np.float32(0.05), efs=efs)
        state, _ = step(state, batch)
        whole = step.whole_state(state)
        got = [t.numpy().copy() for t in tree_leaves(whole.params)]
        got_ef = [t.numpy().copy() for t in tree_leaves(whole.ef_residual)]
        for a, b, p in zip(got, want, params):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(a != p, b != p)
            differ += int((f32bits(a) != f32bits(b)).sum())
            total += a.size
        for a, b in zip(got_ef, want_ef):
            # acc - scale * sign(acc): an ulp of the scale, against the residual's
            # largest magnitude (the cancellation shows it relative to small ones)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * float(np.abs(b).max()))
        params, efs = want, want_ef
    print(f"scaled_sign_ef at (4, 2): {differ} of {total} coordinates differ from JAX's bits")


def test_tp_round_l2_budget_flip_bound():
    """The L2 budget reads the whole leaf's sum of squares, summed in rank
    order: B may differ from T = 1's by an ulp, which flips a symbol only
    where the draw lands between the two thresholds. Bound: at most 1e-4 of
    the updated coordinates differ from T = 1 (the same bound the card's
    float32 model run is held to), printed."""
    tc = CompressionConfig(compressor="sparsign", budget=BudgetConfig(kind="l2_norm", value=0.1),
                           server="majority_vote")
    t2 = _tp_step(tc, "allgather_packed")
    t1 = build_train_step(InjectedTPModel(), TrainStepConfig(
        compression=tc, lr=LrSchedule(base=0.05), vote_impl="allgather_packed"),
        make_mesh((M,), ("data",)))
    params, _, batch = _tp_injected(5)
    s2, _ = t2(t2.shard_state(_state_of(params, "majority_vote")), batch)
    s1, _ = t1(_state_of(params, "majority_vote"), batch)
    a = np.concatenate([t.numpy().ravel() for t in tree_leaves(t2.whole_state(s2).params)])
    b = np.concatenate([t.numpy().ravel() for t in tree_leaves(s1.params)])
    moved = (b != np.concatenate([p.ravel() for p in params])).sum()
    flips = int((f32bits(a) != f32bits(b)).sum())
    print(f"l2_norm at (4, 2): {flips} of {a.size} coordinates differ from T = 1 "
          f"({moved} updated)")
    assert moved > 0 and flips <= 1e-4 * a.size


def _leaves(tree):
    return [t.numpy().copy() for t in tree_leaves(tree)]


def float_flips(got, want, p0) -> int:
    """Coordinates of two runs' leaves that differ beyond float noise: by
    more than 1e-5 of the leaf's largest update plus two ulps of the value.
    A flipped symbol moves a coordinate by a share of a whole decode unit; a
    budget or a decode scale an ulp apart moves it by about an ulp of the
    update."""
    n = 0
    for a, b, p in zip(got, want, p0):
        upd = max(float(np.abs(a - p).max()), float(np.abs(b - p).max()))
        n += int((np.abs(a - b) > 1e-5 * upd + 2 * np.spacing(np.abs(b))).sum())
    return n


def _t2_and_t1(tc, impl, params, batches, **kw):
    """The parameters (leaves) and last metrics of rounds at (4, 2) and
    (4, 1) from one state, one round a batch."""
    t2, t1 = _tp_step(tc, impl, HIER_MESH if impl == "hier" else MESH, **kw), _t1_step(tc, impl,
                                                                                         **kw)
    s2 = t2.shard_state(_state_of(params, tc.server))
    s1 = _state_of(params, tc.server)
    for batch in batches:
        s2, m2 = t2(s2, batch)
        s1, m1 = t1(s1, batch)
    assert float(m2["wire_bytes_per_device"]) == np.float32(
        tp_slice_ledger(t2, InjectedTPModel()))
    return (_leaves(t2.whole_state(s2).params), {k: float(v) for k, v in m2.items()},
            _leaves(s1.params), {k: float(v) for k, v in m1.items()})


#: where a float sum over the whole leaf decides: name: (compressor, server,
#: vote_impl, budget kind, budget value)
FLIP_CASES = {
    "target_sparsity": ("sparsign", "majority_vote", "allgather_packed", "target_sparsity", 0.05),
    "target_sparsity-golomb": ("sparsign_golomb", "majority_vote", "allgather_packed",
                               "target_sparsity", 0.05),
    "qsgd_1bit_l2": ("qsgd_1bit_l2", "mean", "allgather_packed", "fixed", 1.0),
    "scaled_sign": ("scaled_sign", "mean", "psum", "fixed", 1.0),
}


@pytest.mark.parametrize("case", list(FLIP_CASES))
def test_tp_round_float_sum_flip_bound(case):
    """Where a float sum over the whole leaf decides (each of
    target_sparsity's 30 bisection means, 1-bit L2 QSGD's sum of squares,
    scaled sign's L1), T = 2 adds the slices' partials in rank order and
    T = 1 sums the whole leaf: a budget may part by an ulp, which flips a
    symbol only where its draw lands between the two thresholds, and a
    decode scale by an ulp, which moves each update by about an ulp of the
    update. Bound: at most 1e-4 of the coordinates differ from T = 1 beyond
    float noise (``float_flips``; a flipped symbol moves its coordinate by a
    share of a decode unit); both that count and the bits apart printed. The
    golomb wire drops nothing."""
    comp_name, server, impl, kind, value = FLIP_CASES[case]
    tc = CompressionConfig(compressor=comp_name, budget=BudgetConfig(kind=kind, value=value),
                           server=server)
    params, _, b1 = _tp_injected(5)
    _, _, b2 = _tp_injected(6)
    a, m2, b, m1 = _t2_and_t1(tc, impl, params, [b1, b2])
    size = sum(x.size for x in a)
    moved = sum(int(((x != p) | (y != p)).sum()) for x, y, p in zip(a, b, params))
    bitwise = sum(int((f32bits(x) != f32bits(y)).sum()) for x, y in zip(a, b))
    flips = float_flips(a, b, params)
    print(f"{case} at (4, 2), two rounds: {flips} of {size} coordinates differ from T = 1 "
          f"beyond float noise, {bitwise} in any bit ({moved} updated)")
    assert moved > 0 and flips <= 1e-4 * size
    for m in (m1, m2):
        assert m.get("nnz_dropped", 0.0) == 0.0


def _tau_batch(seeds, exact=False):
    """Injected gradients of len(seeds) local steps: (tau, M, ...) a leaf."""
    per = [_tp_injected(sd, exact)[2] for sd in seeds]
    return {k: np.stack([b[k] for b in per]) for k in per[0]}


#: name: (compression config, vote_impl, step options, tau batch): rounds at
#: (4, 2) and (4, 1), held bit for bit
T1_CASES = {
    "local_steps-psum": (CompressionConfig(
        compressor="sparsign", budget=BudgetConfig(value=2.0, local_value=1.5),
        server="majority_vote", local_steps=2), "psum", {}, True),
    "local_steps-packed": (CompressionConfig(
        compressor="sparsign", budget=BudgetConfig(value=0.5, local_value=3.0),
        server="majority_vote", local_steps=2), "allgather_packed", {}, True),
    "elastic-qsgd_1bit_linf-decoded": (CompressionConfig(
        compressor="qsgd_1bit_linf", server="mean"), "psum", {"participation": ELASTIC}, False),
    "elastic-terngrad-packed": (CompressionConfig(
        compressor="terngrad", server="mean"), "allgather_packed", {"participation": ELASTIC},
        False),
    "elastic-golomb": (CompressionConfig(
        compressor="sparsign_golomb", budget=BudgetConfig(value=0.2), server="majority_vote"),
        "allgather_packed", {"participation": ELASTIC, "golomb_p": 0.1}, False),
}


@pytest.mark.parametrize("case", list(T1_CASES))
def test_tp_round_equals_t1_bit_for_bit(case):
    """Two rounds at (4, 2) against (4, 1) from one state, injected
    gradients: Alg. 2's tau = 2 local steps (EF-SPARSIGNSGD's inner sparsign
    at B_l, each slice drawing the whole leaf's counters of step c), and
    elastic rounds on the decoded psum, the scaled-vote gather and the
    Golomb wire (every model rank of a worker takes its mask and weight):
    the same bits, the same metrics but the per-device wire bytes."""
    tc, impl, kw, tau = T1_CASES[case]
    params, _, _ = _tp_injected(0)
    batches = ([_tau_batch((1, 2)), _tau_batch((3, 4))] if tau
               else [_tp_injected(1)[2], _tp_injected(2)[2]])
    a, m2, b, m1 = _t2_and_t1(tc, impl, params, batches, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(f32bits(x), f32bits(y))
    assert any((x != p).any() for x, p in zip(a, params))
    for k in m1:
        if k not in ("wire_bytes_per_device", "gather_hbm_bytes", "loss"):
            assert m2[k] == m1[k], k


def test_tp_golomb_skewed_slice_drops_nothing():
    """target_sparsity 0.05 solves B for the whole leaf. With all of w_up's
    gradient mass in model rank 0's half (its 'ff' columns 0-47 of 96), that
    slice carries about p x the leaf's coordinates: more nonzeros than a
    capacity sized for its own half holds (``golomb_rows(n_slice, p)`` drops
    some), fewer than the leaf's. The slice capacity of the whole leaf
    (``leaf_n``) drops none, and the (4, 2) round reports nnz_dropped 0, as
    the (4, 1) round does."""
    from repro_torch.core.budgets import solve_budget_for_sparsity
    from repro_torch.kernels.golomb.ref import golomb_encode_ref
    from repro_torch.kernels.sparsign.ref import sparsign_ref

    def header(coded, at):
        return int.from_bytes(coded.reshape(-1)[at:at + 4].numpy().tobytes(), "little")

    params, per, batch = _tp_injected(9)
    wup = tree_leaves(TP_SHAPES).index(TP_SHAPES["blocks"][0]["w_up"])
    batch[f"g{wup}"][..., 48:] = 0.0
    g = torch.from_numpy(batch[f"g{wup}"][0])
    sym = sparsign_ref(g, solve_budget_for_sparsity(g, 0.05), 77)
    half = sym[..., :48].contiguous()
    naive = golomb_encode_ref(half, p=0.05)
    sliced = golomb_encode_ref(half, p=0.05, leaf_n=g.numel())
    assert header(naive, 4) > 0 and header(sliced, 4) == 0
    assert header(sliced, 0) == int(torch.count_nonzero(half))
    tc = CompressionConfig(compressor="sparsign_golomb",
                           budget=BudgetConfig(kind="target_sparsity", value=0.05),
                           server="majority_vote")
    _, m2, _, m1 = _t2_and_t1(tc, "allgather_packed", params, [batch])
    print(f"skewed w_up: rank 0's slice holds {header(sliced, 0)} nonzeros, its own-size "
          f"capacity drops {header(naive, 4)}; nnz_dropped T = 2 {m2['nnz_dropped']}, "
          f"T = 1 {m1['nnz_dropped']}")
    assert m2["nnz_dropped"] == 0.0 and m1["nnz_dropped"] == 0.0


def test_tp_fixed_budget_model_step_equals_t1_on_votes():
    """The qwen1.5-4b smoke model itself, M = 4 x T = 2 against M = 4 x T = 1,
    one round of fixed-budget sparsign: every coordinate whose gradient
    symbol the two runs draw alike moves alike; the share that differs is
    printed and held to 1e-4 (the gradients differ in float rounding)."""
    model = Model(get_config("qwen1.5-4b", smoke=True))
    comp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                             server="majority_vote")
    batch = lm_batch(LMStreamConfig(vocab_size=256, seq_len=16, global_batch=4, seed=5), 0)
    out = {}
    for t in (1, 2):
        step = build_train_step(model, TrainStepConfig(
            compression=comp, lr=LrSchedule(base=0.05), vote_impl="psum"), make_host_mesh(M, t))
        state = init_state(model.init(0, device="cpu"), server=comp.server, seed=3)
        if t > 1:
            state = step.shard_state(state)
        state, metrics = step(state, batch)
        if t > 1:
            state = step.whole_state(state)
        out[t] = (np.concatenate([x.numpy().ravel() for x in tree_leaves(state.params)]),
                  {k: float(v) for k, v in metrics.items()})
    flips = int((f32bits(out[1][0]) != f32bits(out[2][0])).sum())
    print(f"model step at (4, 2): {flips} of {out[1][0].size} coordinates differ from T = 1")
    assert flips <= 1e-4 * out[1][0].size
    np.testing.assert_allclose(out[2][1]["loss"], out[1][1]["loss"], rtol=LOSS_RTOL)
    assert out[2][1]["wire_bytes_per_device"] < out[1][1]["wire_bytes_per_device"]


# ------------------------------------------------- (c) processes == one

CHILD = r"""
import sys
import torch
import torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import tree_leaves
from repro_torch.data.synthetic import LMStreamConfig, lm_batch
from repro_torch.dist.collectives import ParticipationSpec
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import Model
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step

def run(data, impl, budget, compressor="sparsign", participation=None):
    model = Model(get_config("qwen1.5-4b", smoke=True))
    comp = CompressionConfig(compressor=compressor, budget=budget, server="majority_vote")
    step = build_train_step(model, TrainStepConfig(
        compression=comp, lr=LrSchedule(base=0.05), vote_impl=impl,
        participation=participation), make_mesh((data, 2), ("data", "model")))
    state = step.shard_state(init_state(model.init(0, device="cpu"), server=comp.server, seed=3))
    for r in range(2):
        batch = lm_batch(LMStreamConfig(vocab_size=256, seq_len=16, global_batch=4, seed=5), r)
        state, metrics = step(state, batch)
    whole = step.whole_state(state)
    return {"params": [t.clone() for t in tree_leaves(whole.params)],
            "metrics": {k: float(v) for k, v in metrics.items()}}

if __name__ == "__main__":
    rank, world, port, out = sys.argv[1:]
    if int(world) > 1:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=int(rank), world_size=int(world))
    try:
        res = {"2x2": run(2, "allgather_packed", BudgetConfig(kind="l2_norm", value=0.1)),
               "1x2": run(1, "psum", BudgetConfig(kind="l2_norm", value=0.1)),
               "1x2-golomb-elastic": run(
                   1, "allgather_packed", BudgetConfig(kind="target_sparsity", value=0.05),
                   "sparsign_golomb", ParticipationSpec(weights=(1.5,), dropout=0.25))}
        torch.save(res, out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def proc_runs(tmp_path_factory):
    """One process holding the whole mesh, and two gloo processes, at once."""
    tmp = tmp_path_factory.mktemp("tp_dist")
    script = tmp / "child.py"
    script.write_text(CHILD)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(tmp)), "OMP_NUM_THREADS": "1"}
    procs = []
    try:
        for world in (1, 2):
            port = _free_port()
            procs += [subprocess.Popen([sys.executable, str(script), str(r), str(world),
                                        str(port), str(tmp / f"w{world}r{r}.pt")],
                                       env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                      for r in range(world)]
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return torch.load(tmp / "w1r0.pt"), [torch.load(tmp / f"w2r{r}.pt") for r in range(2)]


@pytest.mark.parametrize("key", ["2x2", "1x2", "1x2-golomb-elastic"])
def test_two_processes_equal_one(key, proc_runs):
    """(2 data x 2 model): each process holds a whole worker; (1 x 2): each
    holds one model rank, so every TP all-reduce crosses the processes, as
    does each of target_sparsity's 30 bisection sums (the Golomb wire, with
    an elastic weight and dropout: the ranks end on one budget). Both
    ranks' gathered parameters and the metrics equal one process's bit for
    bit (the L2 budget's sums of squares, the bisection's means and the
    loss reductions are ordered)."""
    one, two = proc_runs
    for res in two:
        for a, b in zip(res[key]["params"], one[key]["params"]):
            np.testing.assert_array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))
        assert res[key]["metrics"] == one[key]["metrics"]


# --------------------------------------- (d) checkpoints, launcher, refusals

def _files(d):
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(d).iterdir())}


def _state_leaves(state):
    return tree_leaves(state.params) + tree_leaves(state.ef_residual)


def test_checkpoint_at_t2_restores_across_t(tmp_path):
    """An EF round at T = 2, saved whole: it restores at T = 1 (the plain
    restore) and onto a (2, 2) placement's slices, parameters and residual
    bit for bit."""
    tc = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                           server="scaled_sign_ef")
    params, _, batch = _tp_injected(7)
    t2 = _tp_step(tc, "psum")
    s2, _ = t2(t2.shard_state(_state_of(params, "scaled_sign_ef")), batch)
    whole, write = t2.checkpoint_state(s2)
    assert write
    ckpt.save(str(tmp_path), 1, whole)
    back1, _ = ckpt.restore(str(tmp_path), _state_of(params, "scaled_sign_ef"))
    for a, b in zip(_state_leaves(back1), _state_leaves(whole)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    t22 = _tp_step(tc, "psum", ((2, T), ("data", "model")))
    like = t22.shard_state(_state_of(params, "scaled_sign_ef"))
    back2, _ = ckpt.restore(str(tmp_path), like, shardings=t22.state_shardings(like))
    for a, b in zip(_state_leaves(back2), _state_leaves(s2)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_checkpoint_of_a_votes_round_is_byte_for_byte_the_t1_save(tmp_path):
    """Majority vote at T = 2 and T = 1 from one state and one batch: equal
    parameters, so the two checkpoints are the same files byte for byte."""
    tc = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                           server="majority_vote")
    params, _, batch = _tp_injected(8)
    t1 = build_train_step(InjectedTPModel(), TrainStepConfig(
        compression=tc, lr=LrSchedule(base=0.05), vote_impl="psum"), make_mesh((M,), ("data",)))
    t2 = _tp_step(tc, "psum")
    s1, _ = t1(_state_of(params, "majority_vote"), batch)
    s2, _ = t2(t2.shard_state(_state_of(params, "majority_vote")), batch)
    d1 = ckpt.save(str(tmp_path / "t1"), 1, s1)
    d2 = ckpt.save(str(tmp_path / "t2"), 1, t2.checkpoint_state(s2)[0])
    assert _files(d1) == _files(d2)


def test_launcher_host_model_2_runs_and_resumes_at_t1(tmp_path, capsys):
    """``--host-model 2`` trains two steps and saves; the run resumes at
    T = 1 from the same files."""
    from repro_torch.launch import train as tlaunch
    base = ["--arch", "qwen1.5-4b", "--device", "cpu", "--host-data", "2", "--batch", "4",
            "--seq-len", "16", "--vote-impl", "allgather_packed", "--server", "majority_vote",
            "--ckpt-dir", str(tmp_path)]
    _, hist = tlaunch.main(base + ["--host-model", "2", "--steps", "2"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    _, hist1 = tlaunch.main(base + ["--host-model", "1", "--steps", "3"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert len(hist1) == 1


REFUSALS = {
    "moe": dict(arch="qwen2-moe-a2.7b"),
    "mamba": dict(arch="mamba2-370m"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_what_is_not_ported_under_t2_raises(case):
    """What T > 1 does not port yet raises "not ported yet": MoE and mamba2
    blocks. (The bucketed uplink, the ring and a 'model' axis over a process
    subgroup run: ``tests/test_torch_tp_bucketed.py``.)"""
    kw = dict(REFUSALS[case])
    arch = kw.pop("arch", "qwen1.5-4b")
    comp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=1.0),
                             server="majority_vote")
    cfg = TrainStepConfig(compression=comp, lr=LrSchedule(), vote_impl=kw.pop("impl", "psum"),
                          **kw)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_train_step(Model(get_config(arch, smoke=True)), cfg, make_host_mesh(M, T))


def test_streamed_trainer_under_t2_raises():
    from repro_torch.train.step_streamed import StreamedStepConfig, build_streamed_train_step
    comp = CompressionConfig(compressor="sparsign", server="majority_vote")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_streamed_train_step(Model(get_config("llama4-scout-17b-a16e", smoke=True)),
                                  StreamedStepConfig(compression=comp, lr=LrSchedule()),
                                  make_host_mesh(M, T))


def test_tp_census_each_rank_equals_the_slice_ledger():
    """The analysis gate's tensor-parallel census at (4, 2) on psum, the
    2-bit gather, the Golomb gather (target_sparsity) and the elastic 2-bit
    gather: each model rank's recorded wire bytes equal the slice ledger,
    which the step reports as wire_bytes_per_device; the 'model' axis's own
    reductions are a note, not a finding."""
    from repro_torch.analysis import drivers
    findings, checks = drivers.run_tp_census_checks(device="cpu")
    assert checks == len(drivers.TP_SETUPS) * drivers.TP_T
    assert [f.severity for f in findings] == ["info"] * len(drivers.TP_SETUPS)
    assert all("reductions over 'model'" in f.message for f in findings)
    census, model, step = drivers.run_tp_step("allgather_packed", "cpu")
    assert census.tp_records() and all(r.role == "tp" for r in census.tp_records())
    assert (census.for_model_rank(0).payload_bytes()
            == drivers.tp_slice_ledger(step, model)
            < sum(r.ring_bytes() for r in census.records if r.role == "wire"))
    census, model, step = drivers.run_tp_step("elastic", "cpu")
    assert drivers.tp_slice_ledger_split(step, model)[1] > 0
