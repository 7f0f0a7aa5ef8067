"""The port's Mamba2 mixer and the mamba2-370m model against the JAX
package, on the CPU: the SSD scan, the mixer with its caches and its decode
step from the same numpy inputs; the port's forward against its own decode;
the model's leaves (tied embeddings: no ``lm_head``), its loss and gradients,
its prefill caches and decode steps from JAX's parameters; and the M = 1
trainer step against JAX's ``build_train_step``.

Tolerances: both sides compute the same float32 graph, but torch contracts
the three-operand einsums of ``ssd_chunked`` as a product then one
contraction, in another order than XLA's, and its matmuls and
transcendentals round otherwise. The SSD and the mixer are held to
``REL_TOL`` = 1e-5 of the largest magnitude (measured gaps 1e-7 to 1e-6);
the model's loss to rtol 1e-6 and its gradients to ``GRAD_RTOL`` of each
leaf's norm, as ``test_torch_lm.py`` holds qwen1.5-4b's. JAX's own test of
the chunked scan against the sequential recurrence uses 3e-4
(``tests/test_models.py``).
"""

import dataclasses

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
from repro.models import blocks as jblocks
from repro.models import mamba2 as jm2
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
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import mamba2 as tm2
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.serve import decode as tserve
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step

REL_TOL = 1e-5     # of the largest magnitude: float32 in torch's order against XLA's
GRAD_RTOL = 5e-5   # of each leaf's norm, as for qwen1.5-4b (test_torch_lm.py)
MAX_FLIPS = 4      # coordinates whose sparsign vote may flip in the M = 1 step
ARCH = "mamba2-370m"
B = 2
DIMS = jm2.MambaDims(d_model=32, d_inner=64, n_heads=4, head_dim=16, d_state=8, chunk=8)


def _close(got, want, tol=REL_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ssd_inputs(s, seed=0):
    """JAX's own SSD test inputs (tests/test_models.py), as numpy."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return (rng.randn(B, s, 4, 16).astype(f) * f(0.5), rng.randn(B, s, 4).astype(f),
            rng.randn(4).astype(f) * f(0.1), rng.randn(B, s, 8).astype(f) * f(0.5),
            rng.randn(B, s, 8).astype(f) * f(0.5), rng.randn(4).astype(f))


@pytest.mark.parametrize("s", [32, 17])   # 17: not a whole number of chunks
def test_ssd_chunked_matches_jax(s):
    args = _ssd_inputs(s)
    init = np.random.RandomState(1).randn(B, 4, 16, 8).astype(np.float32)
    for state0 in (None, init):
        jy, jst = jm2.ssd_chunked(*map(jnp.asarray, args), DIMS,
                                  None if state0 is None else jnp.asarray(state0))
        ty, tst = tm2.ssd_chunked(*map(_t, args), DIMS, None if state0 is None else _t(state0))
        assert ty.dtype == tst.dtype == torch.float32
        _close(ty, jy)
        _close(tst, jst)


def _mixer_params(seed=1):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*shp) * 0.1).astype(np.float32)
            for k, (shp, _dt, _ax) in jm2.mamba_param_defs(DIMS, jnp.float32).items()}


def test_mamba_param_defs_match_jax():
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        jdefs = jm2.mamba_param_defs(DIMS, jdtype)
        tdefs = tm2.mamba_param_defs(DIMS, dtype)
        assert list(tdefs) == list(jdefs)
        for k, (shape, dt) in tdefs.items():
            assert shape == jdefs[k][0] and str(dt).split(".")[-1] == jnp.dtype(jdefs[k][1]).name


def test_mamba_forward_and_caches_match_jax():
    """The mixer from zero caches and from given ones (the conv ring and the
    SSD state that prime a continued sequence), with its caches."""
    p = _mixer_params()
    rng = np.random.RandomState(2)
    h = (rng.randn(B, 21, 32) * 0.5).astype(np.float32)
    conv = (rng.randn(B, 3, 64 + 16) * 0.5).astype(np.float32)
    st = (rng.randn(B, 4, 16, 8) * 0.5).astype(np.float32)
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()}
    for inits in ((None, None), (conv, st)):
        jinit = [None if x is None else jnp.asarray(x) for x in inits]
        tinit = [None if x is None else _t(x) for x in inits]
        jout, (jtail, jstate) = jm2.mamba_forward(jp, jnp.asarray(h), DIMS, *jinit,
                                                  return_cache=True)
        tout, (ttail, tstate) = tm2.mamba_forward(tp, _t(h), DIMS, *tinit, return_cache=True)
        _close(tout, jout)
        _close(ttail, jtail)
        _close(tstate, jstate)
        _close(tm2.mamba_forward(tp, _t(h), DIMS, *tinit), jout)


def test_mamba_decode_step_matches_jax():
    p = _mixer_params()
    rng = np.random.RandomState(3)
    h = (rng.randn(B, 1, 32) * 0.5).astype(np.float32)
    conv = (rng.randn(B, 3, 64 + 16) * 0.5).astype(np.float32)
    st = (rng.randn(B, 4, 16, 8) * 0.5).astype(np.float32)
    jout, (jring, jst) = jm2.mamba_decode_step({k: jnp.asarray(v) for k, v in p.items()},
                                               jnp.asarray(h), (jnp.asarray(conv),
                                                                jnp.asarray(st)), DIMS)
    tout, (tring, tst) = tm2.mamba_decode_step({k: _t(v) for k, v in p.items()}, _t(h),
                                               (_t(conv), _t(st)), DIMS)
    _close(tout, jout)
    _close(tring, jring)
    _close(tst, jst)


class _Float64Everywhere:
    """``torch`` with ``float32`` read as ``float64``, for the modules that
    compute in float32 whatever the inputs' dtype."""

    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_mamba_forward_equals_its_decode(precision, monkeypatch):
    """The port's chunked forward against its one-token recurrence over 32
    tokens (four chunks), mirroring JAX's test_mamba_forward_vs_decode: in
    float32 to JAX's 3e-3, and in float64 throughout (the float32 casts
    patched) to 1e-12, so the two paths differ by rounding alone."""
    dtype = np.float32
    if precision == "float64":
        for mod in (tm2, tcommon):
            monkeypatch.setattr(mod, "torch", _Float64Everywhere())
        dtype = np.float64
    p = {k: _t(v.astype(dtype)) for k, v in _mixer_params().items()}
    h = _t((np.random.RandomState(1).randn(B, 32, 32) * 0.5).astype(dtype))
    out, (tail, state) = tm2.mamba_forward(p, h, DIMS, return_cache=True)
    cache = (torch.zeros((B, 3, 64 + 16), dtype=h.dtype),
             torch.zeros((B, 4, 16, 8), dtype=out.dtype if precision == "float64"
                         else torch.float32))
    outs = []
    for t in range(32):
        o, cache = tm2.mamba_decode_step(p, h[:, t:t + 1], cache, DIMS)
        outs.append(o[:, 0])
    tol = 3e-3 if precision == "float32" else 1e-12
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), out.numpy(), rtol=tol, atol=tol)
    np.testing.assert_allclose(cache[1].numpy(), state.numpy(), rtol=tol, atol=tol)
    np.testing.assert_array_equal(cache[0].numpy(), tail.numpy())


def test_segsum_backward_sends_no_nan():
    """The -inf mask goes in before the exp: a gradient through exp(segsum)
    is finite, where exp(diff) * mask would give inf * 0 = NaN."""
    x = (torch.randn(3, 8, dtype=torch.float64) * -30).requires_grad_(True)
    torch.exp(tm2._segsum(x)).sum().backward()
    assert bool(torch.isfinite(x.grad).all())


@pytest.mark.parametrize("smoke", [True, False])
def test_param_leaves_match_jax(smoke):
    """16 leaves (14 a mixer-only block, embed, final_norm; no lm_head), in
    JAX's order, shapes and dtypes (A_log, dt_bias and D float32 in bf16);
    368,338,432 parameters at full width."""
    jleaves = jax.tree_util.tree_flatten_with_path(
        JModel(jget_config(ARCH, smoke=smoke)).param_shapes())[0]
    tm = Model(get_config(ARCH, smoke=smoke))
    tleaves = tree_leaves(tm.param_shapes())
    assert len(tleaves) == len(jleaves) == 16
    assert "lm_head" not in tm.param_shapes() and "ln2" not in tm.param_shapes()["blocks"][0]
    for (path, j), t in zip(jleaves, tleaves):
        assert tuple(t.shape) == tuple(j.shape), jax.tree_util.keystr(path)
        assert str(t.dtype).split(".")[-1] == str(j.dtype), jax.tree_util.keystr(path)
    if not smoke:
        assert tm.param_count() == 368_338_432


@pytest.fixture(scope="module")
def models():
    """The smoke model both ways, from JAX's parameters with every zero leaf
    (norms, biases, A_log, dt_bias, D) given values."""
    jm, tm = JModel(jget_config(ARCH, smoke=True)), Model(get_config(ARCH, smoke=True))
    rng = np.random.RandomState(7)
    jp = jax.tree_util.tree_map(
        lambda x: x if np.asarray(x).any() else jnp.asarray(rng.randn(*x.shape) * 0.1, x.dtype),
        jm.init(jax.random.PRNGKey(1)))
    return jm, tm, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def test_loss_and_grads_match_jax(models):
    """The tied head: embed's gradient is the sum of the embedding's and the
    head's; 21 tokens cross the SSD chunk (8) and the loss chunk (16) with
    ragged last chunks and a masked label."""
    jm, tm, jp, tp = models
    batch = lm_batch(LMStreamConfig(vocab_size=256, seq_len=21, global_batch=B, seed=3), 0)
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
    assert torch.equal(tm.head_weight(tp), tp["embed"].T)


def test_prefill_caches_and_decode_match_jax(models):
    """build_prefill's logits and its caches (the conv tail and the SSD state
    of each layer, against JAX's stacked ``body`` caches), then decode steps
    continuing from them."""
    jm, tm, jp, tp = models
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 256, (B, 21)).astype(np.int32)
    pos = np.broadcast_to(np.arange(21, dtype=np.int32), (B, 21)).copy()
    mesh = j_host_mesh(1, 1)
    jlogits, jcaches = jserve.build_prefill(jm, mesh)(
        jp, {"inputs": jnp.asarray(toks[:, :17]), "positions": jnp.asarray(pos[:, :17])})
    tlogits, tcaches = tserve.build_prefill(tm)(
        tp, {"inputs": torch.from_numpy(toks[:, :17]), "positions": torch.from_numpy(pos[:, :17])})
    _close(tlogits, jlogits)
    shapes = tm.cache_shapes(B, 64)
    assert len(tcaches) == len(shapes) == 2
    for i, (c, sd) in enumerate(zip(tcaches, shapes)):
        assert sorted(c) == sorted(sd) == ["conv", "state"]
        for k in c:
            want = np.asarray(jcaches["body"][0][k][i])
            assert tuple(c[k].shape) == tuple(sd[k].shape) == want.shape
            assert c[k].dtype == sd[k].dtype
            _close(c[k], want)
    jdecode, tdecode = jserve.build_decode_step(jm, mesh), tserve.build_decode_step(tm)
    jc = jcaches
    for p in range(17, 21):
        batch = {"inputs": toks[:, p:p + 1], "positions": pos[:, p:p + 1]}
        jl, jc = jdecode(jp, jc, {k: jnp.asarray(v) for k, v in batch.items()})
        tl, tcaches = tdecode(tp, tcaches, {k: torch.from_numpy(v) for k, v in batch.items()})
        _close(tl, jl)
    for i, c in enumerate(tcaches):
        for k in c:
            _close(c[k], np.asarray(jc["body"][0][k][i]))


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
            print(f"\n[mamba2 M = 1] step {step}: {differ} of {sum(a.size for a in jl)} "
                  f"coordinates differ from JAX")
        assert differ <= MAX_FLIPS


def test_block_cache_defs_follow_jax():
    """conv [B, K-1, d_inner + 2N] in the activation dtype, state [B, H, P, N]
    in float32, at any max_len; a mixer-only block has no ln2."""
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config(ARCH), dtype=dt)
        jcfg = dataclasses.replace(jget_config(ARCH), dtype=dt)
        spec = cfg.pattern[0]
        t = tblocks.block_cache_defs(cfg, spec, 4, 192)
        j = jblocks.block_cache_defs(jcfg, jcfg.pattern[0], 4, 192)
        assert list(t) == list(j)
        for k in t:
            assert t[k][0] == j[k][0] and str(t[k][1]).split(".")[-1] == jnp.dtype(j[k][1]).name
        assert t["conv"][0] == (4, 3, 2048 + 256) and t["state"][0] == (4, 32, 64, 128)
        assert "ln2" not in tblocks.block_param_defs(cfg, spec)
