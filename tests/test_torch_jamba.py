"""jamba-1.5-large-398b in the port against the JAX package, on the CPU at
JAX's ``smoke_config()``: the whole 8-position pattern (mamba with a dense or
a routed-experts FFN, attention without RoPE at position 4), d_model 64, 4
experts top 2, from the same numpy parameters (``params_from_numpy``), in
float32:

(a) the config, the registry entry and the parameter counts; the leaves'
    names, shapes, dtypes and order, smoke and full; ``card_config`` at
    smoke widths through both packages' parameter shapes; the four shapes'
    applicability for every arch; the card cut's two memory guards
    (``dense_init`` of a one-repeat leaf a slice at a time, the L2 budget of
    a leaf above 2^31 coordinates in chunks);
(b) the loss (``test_torch_lm.py``'s rtol 1e-6) and its gradients to
    ``GRAD_RTOL`` = 1e-3 of each leaf's norm, as ``test_torch_moe.py`` holds
    the routed experts': ``test_torch_lm.py``'s 5e-5 is under the rounding
    here, where either side's float32 gradients lie up to 4.0e-4 (the port)
    and 3.0e-4 (JAX) of a leaf's norm from a float64 run of the port, and
    2.4e-4 from each other; the
    prefill's logits and caches and the decode steps after it against JAX's
    builders to ``SERVE_TOL`` of the largest magnitude; decode against the
    full forward within JAX's own 0.15 (``tests/test_serve.py``), the argmax
    equal;
(c) the simple step at M = 1 against JAX's ``build_train_step``; the
    streamed step at M = 1 against JAX's streamed step, with
    ``repro.train.step_streamed.axis_rules`` a no-op in this process only
    (``tests/test_torch_streamed_jax.py`` says why); the port's streamed
    step equal to its simple step at M = 4 at a fixed budget.

JAX's two steps take about 40 s each to compile, so JAX's side runs in
three subprocesses (this file run as a script: the model, the simple step,
the streamed step) started with the module's first test, beside the port's
side of every test; 55-61 s alone, imports
included (each step's subprocess about 48 s of it).
"""

import contextlib
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "jamba-1.5-large-398b"
CHILD_TIMEOUT = 300   # seconds: a guard on each JAX subprocess (about 50 s alone)
STEP_CFG = dict(compressor="sparsign", server="majority_vote")
B = 2


def _jax_params():
    """JAX's model and the parameters every process of this file shares:
    JAX's tree of numpy draws from one seed, in its flatten order (leaves of
    two or more axes a truncated N(0, 1) scaled by the leading axis, JAX's
    init; the others N(0, 0.1^2), where JAX's init gives the norms, biases,
    A_log, dt_bias and D zeros), so no process waits on JAX's init."""
    import jax

    from repro.configs.registry import get_config as jget
    from repro.models.model import Model as JModel

    jm = JModel(jget(ARCH, smoke=True))
    rng = np.random.RandomState(7)

    def draw(sd):
        shape = tuple(sd.shape)
        if len(shape) >= 2 and shape[-1] > 1:
            x = np.clip(rng.randn(*shape), -2.0, 2.0) * shape[0] ** -0.5
        else:
            x = rng.randn(*shape) * 0.1
        return x.astype(sd.dtype)

    return jm, jax.tree_util.tree_map(draw, jm.param_shapes())


def _step_batch(r: int) -> dict:
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    return lm_batch(LMStreamConfig(vocab_size=256, seq_len=16, global_batch=2, seed=5), r)


def _model_batch() -> dict:
    """(b)'s batch: 21 tokens a sequence cross the SSD chunk (8), the
    attention and loss chunks (16), with a masked label."""
    from repro_torch.data.synthetic import LMStreamConfig, lm_batch
    batch = lm_batch(LMStreamConfig(vocab_size=256, seq_len=21, global_batch=B, seed=3), 0)
    batch["labels"][0, -1] = -1
    return batch


def _serve_tokens():
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 256, (B, 21)).astype(np.int32)
    return toks, np.broadcast_to(np.arange(21, dtype=np.int32), (B, 21)).copy()


def _jax_model(res: dict) -> None:
    """The child's (b): the parameters, the loss and its gradients, the
    prefill's logits and caches of 17 tokens and four decode steps after it."""
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_host_mesh as j_host_mesh
    from repro.serve import decode as jserve

    jm, jp = _jax_params()
    for i, leaf in enumerate(jax.tree_util.tree_leaves(jp)):
        res[f"init/{i}"] = np.asarray(leaf)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, bt: jm.loss(p, bt)[0]))(
        jp, {k: jnp.asarray(v) for k, v in _model_batch().items()})
    res["loss"] = np.asarray(loss)
    for i, g in enumerate(jax.tree_util.tree_leaves(grads)):
        res[f"grad/{i}"] = np.asarray(g)
    toks, pos = _serve_tokens()
    mesh = j_host_mesh(1, 1)
    logits, caches = jserve.build_prefill(jm, mesh)(
        jp, {"inputs": jnp.asarray(toks[:, :17]), "positions": jnp.asarray(pos[:, :17])})
    res["prefill"] = np.asarray(logits)
    for i, c in enumerate(caches["body"]):
        for k, v in c.items():
            res[f"cache/{i}/{k}"] = np.asarray(v[0])
    decode = jserve.build_decode_step(jm, mesh)
    for p in range(17, 21):
        batch = {"inputs": toks[:, p:p + 1], "positions": pos[:, p:p + 1]}
        logits, caches = decode(jp, caches, {k: jnp.asarray(v) for k, v in batch.items()})
        res[f"decode/{p}"] = np.asarray(logits)


def _jax_child(kind: str, out_path: str) -> None:
    """A subprocess: ``model`` (b)'s JAX side, or (c)'s two steps of JAX's
    ``simple`` or ``streamed`` step at M = 1 on a (1, 1) mesh; writes its
    arrays to ``out_path``."""
    res = {}
    if kind == "model":
        _jax_model(res)
        np.savez(out_path, **res)
        return
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    import repro.train.step_streamed as jss
    from repro.core.algorithm import CompressionConfig as JConfig
    from repro.core.budgets import BudgetConfig as JBudget
    from repro.dist import compat as jcompat
    from repro.launch.mesh import make_host_mesh as j_host_mesh
    from repro.train.state import LrSchedule as JLr
    from repro.train.state import init_state as j_init_state
    from repro.train.step_simple import TrainStepConfig as JStepConfig
    from repro.train.step_simple import build_train_step as j_build

    jss.axis_rules = lambda rules, mesh=None: contextlib.nullcontext()   # this process only
    jm, jp = _jax_params()
    mesh = j_host_mesh(1, 1)
    kw = dict(compression=JConfig(budget=JBudget(value=2.0), **STEP_CFG), lr=JLr(base=0.05),
              worker_axes=("data",), vote_impl="allgather_packed", donate=False)
    step = (j_build(jm, JStepConfig(**kw), mesh) if kind == "simple" else
            jss.build_streamed_train_step(jm, jss.StreamedStepConfig(**kw), mesh))
    state = jax.device_put(j_init_state(jp, server=STEP_CFG["server"], seed=7),
                           NamedSharding(mesh, PartitionSpec()))
    for r in range(2):
        with jcompat.set_mesh(mesh):
            state, m = step(state, {k: jnp.asarray(v) for k, v in _step_batch(r).items()})
        for k, v in m.items():
            res[f"m{r}/{k}"] = np.asarray(v)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(state.params)):
            res[f"p{r}/{i}"] = np.asarray(leaf)
    np.savez(out_path, **res)


if __name__ == "__main__":   # a subprocess of (c)
    _jax_child(sys.argv[1], sys.argv[2])
    sys.exit(0)


import jax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import shapes as jshapes  # noqa: E402
from repro.configs.registry import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.configs.registry import trainer_mode as j_trainer_mode  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import jamba15_large, shapes  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config, trainer_mode  # noqa: E402
from repro_torch.core.algorithm import CompressionConfig  # noqa: E402
from repro_torch.core.budgets import BudgetConfig  # noqa: E402
from repro_torch.core.compressors import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.serve import decode as tserve  # noqa: E402
from repro_torch.train import step_streamed as tss  # noqa: E402
from repro_torch.train.state import LrSchedule, init_state  # noqa: E402
from repro_torch.train.step_simple import TrainStepConfig, build_train_step  # noqa: E402

from test_torch_lm import _port_of  # noqa: E402
from test_torch_streamed import _bits, _run_step  # noqa: E402

GRAD_RTOL = 1e-3         # of each leaf's norm (see the module's text)
SERVE_TOL = 2e-5         # of the largest magnitude, as tests/test_torch_serve.py holds it
DECODE_VS_FORWARD = 0.15  # JAX's own bound for jamba (tests/test_serve.py)
MAX_FLIPS = 4            # coordinates whose sparsign vote may flip at M = 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread in this process: its smoke-size work is bound by
    op launches, and the JAX subprocesses need the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


# --------------------------------------------------- (a) config and shapes

def test_config_registry_and_counts_match_jax():
    assert trainer_mode(ARCH) == j_trainer_mode(ARCH) == "streamed"
    for smoke in (True, False):
        cfg, jcfg = get_config(ARCH, smoke), jget(ARCH, smoke)
        assert cfg == _port_of(jcfg)
        assert cfg.supports_long_context
        assert [(s.mixer, s.use_rope, s.moe) for s in cfg.pattern] == [
            ("attn", False, False) if i == 4 else ("mamba", True, i % 2 == 1) for i in range(8)]
    full = get_config(ARCH)
    assert full.param_count() == 397_596_263_520
    assert full.active_param_count() == 93_190_456_416
    for arch in ARCH_IDS:   # every config's counts are JAX's
        cfg, jcfg = get_config(arch), jget(arch)
        assert (cfg.param_count(), cfg.active_param_count()) == (
            jcfg.param_count(), jcfg.active_param_count()), arch


@pytest.mark.parametrize("smoke", [True, False])
def test_param_leaves_match_jax(smoke):
    """One stacked dict a pattern position, JAX's names in its order, shapes
    and dtypes (the routers, A_log, dt_bias and D float32 among bf16)."""
    jleaves = jax.tree_util.tree_flatten_with_path(JModel(jget(ARCH, smoke=smoke)).param_shapes())[0]
    tm = Model(get_config(ARCH, smoke=smoke))
    shapes_ = tm.param_shapes()
    names = [f"blocks/{i}/{k}" for i, bp in enumerate(shapes_["blocks"]) for k in sorted(bp)]
    names += [k for k in sorted(shapes_) if k != "blocks"]
    assert names == [jax.tree_util.keystr(p).replace("['", "").replace("']", "/")
                     .replace("[", "").replace("]", "/").rstrip("/") for p, _ in jleaves]
    tleaves = tree_leaves(shapes_)
    assert len(tleaves) == len(jleaves)
    for (path, j), t in zip(jleaves, tleaves):
        assert tuple(t.shape) == tuple(j.shape), jax.tree_util.keystr(path)
        assert str(t.dtype).split(".")[-1] == str(j.dtype), jax.tree_util.keystr(path)


def test_card_config_cuts_the_pattern():
    """``card_config((2, 5))``: mamba+dense, mamba+MoE, attention without
    RoPE, one repeat, every width kept; at smoke widths its leaves equal
    JAX's model of the same cut, and at published widths the card's
    12,906,784,576 parameters with a 3,221,225,472-coordinate expert leaf."""
    for smoke in (True, False):
        cut = jamba15_large.card_config((2, 5), smoke=smoke)
        base = get_config(ARCH, smoke)
        assert cut.n_layers == 3 and cut.n_repeats == 1 and cut.pattern == base.pattern[2:5]
        assert dataclasses.replace(cut, name=base.name, n_layers=base.n_layers,
                                   pattern=base.pattern) == base
        assert cut.name == f"{base.name}@p2-4"
    jcfg = jget(ARCH, smoke=True)
    jcut = dataclasses.replace(jcfg, n_layers=3, pattern=jcfg.pattern[2:5])
    jl = jax.tree_util.tree_leaves(JModel(jcut).param_shapes())
    tl = tree_leaves(Model(jamba15_large.card_config((2, 5), smoke=True)).param_shapes())
    assert [tuple(s.shape) for s in tl] == [tuple(s.shape) for s in jl]
    full = Model(jamba15_large.card_config((2, 5)))
    assert full.param_count() == 12_906_784_576
    assert max(int(np.prod(s.shape)) for s in tree_leaves(full.param_shapes())) == 3_221_225_472
    with pytest.raises(ValueError, match="not a cut"):
        jamba15_large.card_config((5, 5))


def test_shapes_applicable_match_jax():
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, s in shapes.SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(jshapes.SHAPES[name])
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        for smoke in (True, False):
            cfg, jcfg = get_config(arch, smoke), jget(arch, smoke)
            for s in shapes.SHAPES.values():
                assert shapes.applicable(cfg, s) == jshapes.applicable(
                    jcfg, jshapes.SHAPES[s.name]), (arch, s.name)
            assert ([(c[0].name,) + c[1:] for c in shapes.all_cells(cfg)]
                    == [(c[0].name,) + tuple(c[1:]) for c in jshapes.all_cells(jcfg)])


def test_dense_init_slices_a_one_repeat_leaf(monkeypatch):
    """A stacked leaf of one repeat (the card's cut) above SLICED_DRAW_COORDS
    is drawn one expert at a time: the draws a slice of its first axis
    longer than 1, with fan-in the leading axis, as JAX's."""
    from repro_torch.models import common
    monkeypatch.setattr(common, "SLICED_DRAW_COORDS", 1000)
    shape = (1, 4, 30, 20)
    got = common.dense_init(torch.Generator().manual_seed(5), shape, torch.bfloat16, "cpu")
    gen = torch.Generator().manual_seed(5)
    for e in range(shape[1]):
        assert torch.equal(got[0, e], common._draw(gen, shape[2:], 1.0, "cpu").to(torch.bfloat16))


def test_l2_budget_of_a_huge_leaf_in_chunks():
    """The L2 budget of a bf16 leaf takes its float32 norm inside the
    reduction (on the card, no float32 copy of a 3.2 B-coordinate leaf, in
    one chunk): bit for bit the norm of the leaf's float32 copy, whole and
    a row at a time."""
    from repro_torch.core import budgets
    g = torch.randn(4, 999, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    cfg = budgets.BudgetConfig(kind="l2_norm", value=0.1)
    whole = budgets.resolve_budget(cfg, g)
    ref = torch.sqrt(torch.tensor(float(g.numel()))) / torch.linalg.vector_norm(
        g.to(torch.float32)) * 0.1
    assert torch.equal(whole, ref)
    rows = budgets.resolve_budget(cfg, g, rows=True)
    ref_rows = torch.sqrt(torch.tensor(999.0)) / torch.linalg.vector_norm(
        g.to(torch.float32), dim=1) * 0.1
    assert torch.equal(rows.reshape(-1), ref_rows)


# ----------------------------------------------------- (b) model and serving

@pytest.fixture(scope="module", autouse=True)
def jax_side(tmp_path_factory):
    """JAX's side of (b) and its simple and streamed steps, each in its own
    subprocess, started before the module's first test; ``jax_side(kind)``
    waits for one and returns its arrays."""
    out = tmp_path_factory.mktemp("jamba")
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(out)), "JAX_PLATFORMS": "cpu"}
    procs = {kind: subprocess.Popen([sys.executable, __file__, kind, str(out / f"{kind}.npz")],
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True) for kind in ("model", "simple", "streamed")}

    done = {}

    def result(kind):
        if kind not in done:
            _, err = procs[kind].communicate(timeout=CHILD_TIMEOUT)
            assert procs[kind].returncode == 0, err[-3000:]
            done[kind] = dict(np.load(out / f"{kind}.npz"))
        return done[kind]

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def models():
    """The port's smoke model and the shared parameters (``_jax_params``) as
    the port's tree."""
    _, jp = _jax_params()
    return Model(get_config(ARCH, smoke=True)), params_from_numpy(jp)


def test_loss_and_grads_match_jax(models, jax_side):
    tm, tp = models
    batch = _model_batch()
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    tl = tm.loss(tree_unflatten(tp, leaves), {k: torch.from_numpy(v) for k, v in batch.items()})[0]
    tg = torch.autograd.grad(tl, leaves)
    jres = jax_side("model")
    np.testing.assert_allclose(float(tl.detach()), float(jres["loss"]), rtol=1e-6)
    for i, t in enumerate(tg):
        j, t = jres[f"grad/{i}"], t.numpy()
        assert np.linalg.norm(t - j) <= GRAD_RTOL * np.linalg.norm(j) + 1e-12


def test_prefill_and_decode_match_jax(models, jax_side):
    """build_prefill's logits and the hybrid caches (a KV cache at position 4
    only, conv rings and SSD states elsewhere), then decode steps from them."""
    tm, tp = models
    jres = jax_side("model")
    toks, pos = _serve_tokens()
    tlogits, tc = tserve.build_prefill(tm)(
        tp, {"inputs": torch.from_numpy(toks[:, :17]), "positions": torch.from_numpy(pos[:, :17])})
    _close(tlogits, jres["prefill"], SERVE_TOL)
    assert [sorted(c) for c in tc] == [["k", "pos", "v"] if i == 4 else ["conv", "state"]
                                       for i in range(8)]
    for i, c in enumerate(tc):
        for k in c:
            want = jres[f"cache/{i}/{k}"]
            if k == "pos":
                np.testing.assert_array_equal(c[k].numpy(), want)
            else:
                _close(c[k], want, SERVE_TOL)
    tdecode = tserve.build_decode_step(tm)
    for p in range(17, 21):
        batch = {"inputs": toks[:, p:p + 1], "positions": pos[:, p:p + 1]}
        tl, tc = tdecode(tp, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
        _close(tl, jres[f"decode/{p}"], SERVE_TOL)


def test_decode_equals_the_full_forward(models):
    """JAX's test_prefill_then_decode_equals_full_forward on the port: a
    16-token prefill into a deep cache, one decode step at position 16,
    against the last logits of the 17-token forward."""
    tm, tp = models
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, 256, (B, 17)).astype(np.int32))
    pos = torch.arange(17, dtype=torch.int32).expand(B, 17)
    caches = tm.init_cache(B, 32, device="cpu")
    _, pre = tm.prefill(tp, {"inputs": toks[:, :16], "positions": pos[:, :16]})
    for c, p in zip(caches, pre):
        for k, v in p.items():
            if k == "state" or k == "conv":
                c[k].copy_(v)
            else:
                c[k][:, :16] = v
    logits_dec, _ = tm.decode_step(tp, caches, {"inputs": toks[:, 16:], "positions": pos[:, 16:]})
    h = tm.forward_hidden(tp, {"inputs": toks, "positions": pos})
    logits_full = (h[:, -1] @ tm.head_weight(tp)).to(torch.float32)
    rel = float((logits_dec - logits_full).abs().max() / logits_full.abs().max())
    assert rel < DECODE_VS_FORWARD, rel
    assert torch.equal(logits_dec.argmax(-1), logits_full.argmax(-1))


# ---------------------------------------------------------------- (c) steps

@pytest.mark.parametrize("kind", ["simple", "streamed"])
def test_m1_step_matches_jax(kind, models, jax_side, capsys):
    """Two steps at M = 1 on allgather_packed with the majority vote, from
    the same weights: JAX's ``build_train_step`` against the port's simple
    step, JAX's streamed step against the port's. The gradients round
    otherwise, so a sparsign draw may land between them and flip a vote: at
    most MAX_FLIPS coordinates differ."""
    tm, tp = models
    cfg = TrainStepConfig if kind == "simple" else tss.StreamedStepConfig
    build = build_train_step if kind == "simple" else tss.build_streamed_train_step
    tstep = build(tm, cfg(compression=CompressionConfig(budget=BudgetConfig(value=2.0),
                                                        **STEP_CFG),
                          lr=LrSchedule(base=0.05), vote_impl="allgather_packed"),
                  make_host_mesh(1))
    tstate = init_state(tree_unflatten(tp, [t.clone() for t in tree_leaves(tp)]),
                        server=STEP_CFG["server"], seed=7)
    n = len(tree_leaves(tp))
    ours = []
    for r in range(2):
        tstate, tmet = tstep(tstate, _step_batch(r))
        ours.append(({k: float(v) for k, v in tmet.items()},
                     [t.numpy().copy() for t in tree_leaves(tstate.params)]))
    jres = jax_side(kind)
    for r, (tmet, tl) in enumerate(ours):
        for k in ("wire_bytes_per_device", "participated", "gather_hbm_bytes", "lr"):
            assert float(tmet[k]) == float(jres[f"m{r}/{k}"]), (r, k)
        np.testing.assert_allclose(float(tmet["loss"]), float(jres[f"m{r}/loss"]), rtol=1e-6)
        jl = [jres[f"p{r}/{i}"] for i in range(n)]
        differ = sum(int((_bits(a) != _bits(b)).sum()) for a, b in zip(jl, tl))
        with capsys.disabled():
            print(f"\n[jamba {kind} M = 1] step {r}: {differ} of {sum(a.size for a in jl)} "
                  f"coordinates differ from JAX")
        assert differ <= MAX_FLIPS


def test_m4_streamed_equals_simple():
    """One repeat of the pattern, a fixed budget: the streamed step (per leaf
    and bucketed) equals the simple step bit for bit at M = 4."""
    model = Model(get_config(ARCH, smoke=True))
    comp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                             server="majority_vote")
    ref, ref_m = _run_step(model, comp, "allgather_packed", {}, streamed=False, steps=1)
    for bucketed in (False, True):
        got, m = _run_step(model, comp, "allgather_packed", {}, streamed=True,
                           bucketed=bucketed, steps=1)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        for k in ("loss", "nnz_frac", "participated", "lr"):
            assert m[k] == ref_m[k], (bucketed, k)
