"""The port's MoE FFN (``models/moe.py``) and the qwen2-moe-a2.7b model
against the JAX package, on the CPU: capacity, the router (softmax and
sigmoid, padded experts masked), the token and expert selections
(``jax.lax.top_k``'s, ties included), the gather and dense paths with their
gradients, capacity drops; the model's leaves, loss and gradients, prefill
and decode, and the M = 1 trainer step, from JAX's parameters.

Tolerances: the FFN in float32 to ``REL_TOL`` = 1e-5 of the largest
magnitude (measured gaps 1e-7 to 3e-7: torch's matmuls and XLA's round in
other orders); serving's logits and caches to ``SERVE_TOL`` = 2e-5, as
``tests/test_torch_serve.py`` holds qwen1.5-4b's (measured up to 1.4e-5
here, 9.9e-6 for qwen1.5-4b's prefill); selections, capacities and cache
positions exactly. The
model's gradients to ``GRAD_RTOL`` = 1e-3 of each leaf's norm: at this size
either side's float32 gradients lie 1.1e-4 to 1.4e-4 of a leaf's norm from a
float64 run of the port, and 1.0e-4 from each other, so the gap is
rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from repro.configs.registry import get_config as jget_config
from repro.core.algorithm import CompressionConfig as JConfig
from repro.core.budgets import BudgetConfig as JBudget
from repro.dist import compat as jcompat
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import moe as jmoe
from repro.models.model import Model as JModel
from repro.serve import decode as jserve
from repro.train.state import LrSchedule as JLr
from repro.train.state import init_state as j_init_state
from repro.train.step_simple import TrainStepConfig as JStepConfig
from repro.train.step_simple import build_train_step as j_build
from repro_torch.configs.registry import get_config
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.data.synthetic import LMStreamConfig, lm_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.serve import decode as tserve
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step

REL_TOL = 1e-5     # of the largest magnitude: float32 in torch's order against XLA's
SERVE_TOL = 2e-5   # the logits and caches of serving, as tests/test_torch_serve.py holds them
GRAD_RTOL = 1e-3   # of each leaf's norm, the model's gradients (see the module's text)
MAX_FLIPS = 4      # coordinates whose sparsign vote may flip in the M = 1 step
ARCH = "qwen2-moe-a2.7b"


def _dims(**kw):
    base = dict(n_experts=6, n_experts_padded=8, top_k=2, d_model=16, d_ff=32,
                capacity_factor=8.0)
    base.update(kw)
    return jmoe.MoEDims(**base), tmoe.MoEDims(**base)


def _close(got, want, tol=REL_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _params(dims, n_shared, seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*shp) * 0.2).astype(np.float32)
            for k, (shp, _dt) in jmoe.moe_param_shapes(dims, n_shared, jnp.float32).items()}


@pytest.mark.parametrize("cf,t,k,e", [(1.25, 4096, 4, 60), (1.25, 8192, 4, 60), (1.25, 4, 4, 60),
                                      (4.0, 42, 4, 6), (0.2, 256, 2, 4), (1.0, 3, 1, 16),
                                      (1.25, 17, 2, 64)])
def test_capacity_matches_jax(cf, t, k, e):
    """Truncated, rounded up to 8, capped at T (T is the batch at decode)."""
    jd, td = _dims(n_experts=e, n_experts_padded=e, top_k=k, capacity_factor=cf)
    assert tmoe.capacity(td, t) == jmoe.capacity(jd, t)


@pytest.mark.parametrize("act", ["softmax", "sigmoid"])
def test_router_probs_match_jax_and_mask_the_padding(act):
    jd, td = _dims(router_act=act)
    rng = np.random.RandomState(3)
    w = rng.randn(16, 8).astype(np.float32)
    x = rng.randn(100, 16).astype(np.float32)
    jp = jmoe.router_probs(jnp.asarray(x), jnp.asarray(w), jd)
    tp = tmoe.router_probs(torch.from_numpy(x), torch.from_numpy(w), td)
    assert tp.dtype == torch.float32
    _close(tp, jp)
    assert float(tp[:, 6:].max()) == float(jp[:, 6:].max()) == 0.0


def test_top_k_breaks_ties_as_jax_does():
    """``jax.lax.top_k`` keeps the lower index among equal values; the port's
    stable sort does the same, on rows full of ties."""
    rng = np.random.RandomState(5)
    x = rng.randint(0, 4, (40, 64)).astype(np.float32) / 4
    for k in (1, 4, 17, 64):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tmoe.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_selections_match_jax(cf):
    """The top-k gates and experts of each token, and each expert's top-C
    tokens, equal JAX's; the tokens are repeated, so equal gates tie at the
    capacity edge and among the experts (two equal router columns)."""
    jd, td = _dims(capacity_factor=cf)
    rng = np.random.RandomState(6)
    w = rng.randn(16, 8).astype(np.float32)
    w[:, 3] = w[:, 1]
    x = np.repeat(rng.randn(12, 16).astype(np.float32), 4, axis=0)
    jprobs = jmoe.router_probs(jnp.asarray(x), jnp.asarray(w), jd)
    jg, je = jmoe._topk_gates(jprobs, jd)
    tg, te = tmoe._topk_gates(tmoe.router_probs(torch.from_numpy(x), torch.from_numpy(w), td),
                              td)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _close(tg, jg)
    assert bool((te == 1).any() and (te == 3).any())
    assign = np.zeros((48, 8), np.float32)
    np.put_along_axis(assign, np.asarray(je), np.asarray(jg), axis=1)
    c = tmoe.capacity(td, 48)
    assert c == jmoe.capacity(jd, 48)
    js, jt = jax.lax.top_k(jnp.asarray(assign.T), c)
    ts, tt = tmoe.top_k(torch.from_numpy(assign.T.copy()), c)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _ffn_both(jd, td, n_shared, x, seed, impl):
    """moe_ffn's output and the gradients of <y, g> for the parameters and x."""
    p = _params(jd, n_shared, seed)
    g = np.random.RandomState(seed + 1).randn(*x.shape).astype(np.float32)
    @jax.jit
    def jax_side(pp, xx, gg):
        y, vjp = jax.vjp(lambda a, b: jmoe.moe_ffn(a, b, jd, impl=impl), pp, xx)
        return y, vjp(gg)

    jy, (jgp, jgx) = jax_side({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                              jnp.asarray(g))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tmoe.moe_ffn(tp, tx, td, impl=impl)
    (ty * torch.from_numpy(g)).sum().backward()
    return (ty, {**{k: v.grad for k, v in tp.items()}, "x": tx.grad},
            jy, {**jgp, "x": jgx})


@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_moe_ffn_and_its_gradients_match_jax(impl):
    jd, td = _dims()
    x = (np.random.RandomState(2).randn(64, 16) * 0.5).astype(np.float32)
    ty, tg, jy, jg = _ffn_both(jd, td, 2, x, 2, impl)
    _close(ty, jy)
    for k in jg:
        _close(tg[k], jg[k])


def test_gather_equals_dense_when_nothing_drops():
    _, td = _dims()
    p = {k: torch.from_numpy(v) for k, v in _params(_dims()[0], 2, 2).items()}
    x = torch.from_numpy((np.random.RandomState(2).randn(64, 16) * 0.5).astype(np.float32))
    _close(tmoe.moe_ffn(p, x, td, impl="gather"), tmoe.moe_ffn(p, x, td, impl="dense").numpy())


def test_capacity_drops_match_jax():
    """At capacity_factor 0.2 tokens drop: the gather path equals JAX's, and
    both differ from the dense path."""
    jd, td = _dims(n_experts=4, n_experts_padded=4, capacity_factor=0.2)
    x = (np.random.RandomState(4).randn(256, 16) * 0.5).astype(np.float32)
    ty, tg, jy, jg = _ffn_both(jd, td, 0, x, 4, "gather")
    _close(ty, jy)
    for k in jg:
        _close(tg[k], jg[k])
    p = {k: torch.from_numpy(v) for k, v in _params(jd, 0, 4).items()}
    dense = tmoe.moe_ffn(p, torch.from_numpy(x), td, impl="dense")
    assert float((ty.detach() - dense).abs().max()) > 1e-4


@pytest.mark.parametrize("top_k", [1, 2])
def test_sigmoid_router_with_renormalised_gates_matches_jax(top_k):
    """The llama4-style router: sigmoid gates, renormalised over the top k.
    At k = 1 every gate is 1 whatever the logits, so the router's gradient
    is zero but for rounding on both sides."""
    jd, td = _dims(router_act="sigmoid", renorm_topk=True, top_k=top_k, capacity_factor=2.0)
    x = (np.random.RandomState(8).randn(48, 16) * 0.5).astype(np.float32)
    ty, tg, jy, jg = _ffn_both(jd, td, 1, x, 8, "gather")
    _close(ty, jy)
    for k in jg:
        if k == "router" and top_k == 1:
            assert float(tg[k].abs().max()) < 1e-6 and float(jnp.abs(jg[k]).max()) < 1e-6
        else:
            _close(tg[k], jg[k])


@pytest.mark.parametrize("smoke", [True, False])
def test_param_leaves_match_jax(smoke):
    """19 leaves in JAX's order, shapes and dtypes, the router float32 among
    bf16 leaves; 15,146,403,840 parameters at full width."""
    jleaves = jax.tree_util.tree_flatten_with_path(
        JModel(jget_config(ARCH, smoke=smoke)).param_shapes())[0]
    tm = Model(get_config(ARCH, smoke=smoke))
    tleaves = tree_leaves(tm.param_shapes())
    assert len(tleaves) == len(jleaves) == 19
    for (path, j), t in zip(jleaves, tleaves):
        assert tuple(t.shape) == tuple(j.shape), jax.tree_util.keystr(path)
        assert str(t.dtype).split(".")[-1] == str(j.dtype), jax.tree_util.keystr(path)
    assert tm.param_shapes()["blocks"][0]["moe_router"].dtype == torch.float32
    if not smoke:
        assert tm.param_count() == 15_146_403_840


@pytest.fixture(scope="module")
def models():
    """The smoke model both ways, from JAX's parameters with every zero leaf
    (norms, biases) given values."""
    jm, tm = JModel(jget_config(ARCH, smoke=True)), Model(get_config(ARCH, smoke=True))
    rng = np.random.RandomState(7)
    jp = jax.tree_util.tree_map(
        lambda x: x if np.asarray(x).any() else jnp.asarray(rng.randn(*x.shape) * 0.1, x.dtype),
        jm.init(jax.random.PRNGKey(1)))
    return jm, tm, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def test_loss_and_grads_match_jax(models):
    """21 tokens a sequence cross the attention chunk (16) and the loss chunk
    (16), with a masked label; 42 tokens at capacity factor 4."""
    jm, tm, jp, tp = models
    batch = lm_batch(LMStreamConfig(vocab_size=256, seq_len=21, global_batch=2, seed=3), 0)
    batch["labels"][0, -1] = -1
    jl, jg = jax.jit(jax.value_and_grad(lambda p, bt: jm.loss(p, bt)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    tl = tm.loss(tree_unflatten(tp, leaves), {k: torch.from_numpy(v) for k, v in batch.items()})[0]
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    for j, t in zip(jax.tree_util.tree_leaves(jg), tg):
        j, t = np.asarray(j), t.numpy()
        assert np.linalg.norm(t - j) <= GRAD_RTOL * np.linalg.norm(j) + 1e-12


def test_prefill_and_decode_match_jax(models):
    """build_prefill's logits and caches, then decode steps continuing from
    them (a batch of 2: capacity caps at the batch)."""
    jm, tm, jp, tp = models
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 256, (2, 21)).astype(np.int32)
    pos = np.broadcast_to(np.arange(21, dtype=np.int32), (2, 21)).copy()
    mesh = j_host_mesh(1, 1)
    jlogits, jc = jserve.build_prefill(jm, mesh)(
        jp, {"inputs": jnp.asarray(toks[:, :17]), "positions": jnp.asarray(pos[:, :17])})
    tlogits, tc = tserve.build_prefill(tm)(
        tp, {"inputs": torch.from_numpy(toks[:, :17]), "positions": torch.from_numpy(pos[:, :17])})
    _close(tlogits, jlogits, SERVE_TOL)
    for i, c in enumerate(tc):
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["body"][0]["pos"][i]))
        for k in ("k", "v"):
            _close(c[k], jc["body"][0][k][i], SERVE_TOL)
    jdecode, tdecode = jserve.build_decode_step(jm, mesh), tserve.build_decode_step(tm)
    for p in range(17, 21):
        batch = {"inputs": toks[:, p:p + 1], "positions": pos[:, p:p + 1]}
        jl, jc = jdecode(jp, jc, {k: jnp.asarray(v) for k, v in batch.items()})
        tl, tc = tdecode(tp, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
        _close(tl, jl, SERVE_TOL)


def test_m1_train_step_matches_jax(models, capsys):
    """Two steps of JAX's build_train_step at M = 1 (allgather_packed,
    majority vote) against the port's from the same weights; the gradients
    round otherwise, so a sparsign draw may land between them and flip a
    vote: at most MAX_FLIPS coordinates differ."""
    jm, tm, jp, tp = models
    comp = dict(compressor="sparsign", server="majority_vote")
    mesh = j_host_mesh(1, 1)
    jstep = j_build(jm, JStepConfig(compression=JConfig(budget=JBudget(value=2.0), **comp),
                                    lr=JLr(base=0.05), worker_axes=("data",),
                                    vote_impl="allgather_packed", donate=False), mesh)
    tstep = build_train_step(tm, TrainStepConfig(
        compression=CompressionConfig(budget=BudgetConfig(value=2.0), **comp),
        lr=LrSchedule(base=0.05), vote_impl="allgather_packed"), make_host_mesh(1))
    jstate = jax.device_put(j_init_state(jp, server="majority_vote", seed=7),
                            NamedSharding(mesh, PartitionSpec()))
    tstate = init_state(tree_unflatten(tp, [t.clone() for t in tree_leaves(tp)]),
                        server="majority_vote", seed=7)
    for step in range(2):
        batch = lm_batch(LMStreamConfig(vocab_size=256, seq_len=16, global_batch=2, seed=5),
                         step)
        with jcompat.set_mesh(mesh):
            jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tmet = tstep(tstate, batch)
        for k in ("wire_bytes_per_device", "participated", "gather_hbm_bytes", "lr"):
            assert float(tmet[k]) == float(jmet[k]), (step, k)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-6)
        jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate.params)]
        tl = [t.numpy() for t in tree_leaves(tstate.params)]
        differ = sum(int((a.view(np.int32) != b.view(np.int32)).sum()) for a, b in zip(jl, tl))
        with capsys.disabled():
            print(f"\n[qwen2-moe M = 1] step {step}: {differ} of {sum(a.size for a in jl)} "
                  f"coordinates differ from JAX")
        assert differ <= MAX_FLIPS
