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
    under T > 1 raises.
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


def jax_round(params, per, jc, *, seed, step, lr, efs=None):
    """One round of the trainer on whole leaves from the JAX package's
    parts, worker by worker: seeds and masks (``sampling``), the engine's
    compress_leaf (jnp backend), the messages summed (int8 votes, or decoded
    floats in worker order for a scaled row) and server_apply."""
    rseed = jsampling.round_seed(jnp.uint32(seed), jnp.int32(step))
    wseeds = [jprng.fold_seed(rseed, 0x5EED) + jnp.uint32(w) * jnp.uint32(0x9E3779B9)
              for w in range(M)]
    mask = [jsampling.participation_mask(rseed, jnp.int32(step), jnp.uint32(w),
                                         jc.worker_sample_fraction) for w in range(M)]
    n_sel = sum(jnp.asarray(m, jnp.float32) for m in mask)
    out, out_ef = [], []
    for i, p in enumerate(params):
        msgs = [jengine.compress_leaf(jnp.asarray(per[i][w]), jc, jprng.fold_seed(wseeds[w], i),
                                      backend="jnp") for w in range(M)]
        if jc.compressor == "qsgd8":
            total = None
            for w, msg in enumerate(msgs):
                dec = jnp.where(mask[w], msg.values.astype(jnp.float32) * msg.scale, 0.0)
                total = dec if total is None else total + dec
            new, ef = jengine.server_apply(jnp.asarray(p), total, jc, lr=lr, n_sel=n_sel,
                                           server="mean", backend="jnp")
        else:
            votes = sum(jnp.where(mask[w], m.values, 0).astype(jnp.int32)
                        for w, m in enumerate(msgs)).astype(jnp.int8)
            new, ef = jengine.server_apply(
                jnp.asarray(p), votes, jc, lr=lr, n_sel=n_sel,
                ef=None if efs is None else jnp.asarray(efs[i]), backend="jnp")
        out.append(np.asarray(new))
        out_ef.append(None if ef is None else np.asarray(ef))
    return out, out_ef


def _tp_step(tcomp, impl, mesh=((M, T), ("data", "model"))):
    return build_train_step(InjectedTPModel(), TrainStepConfig(
        compression=tcomp, lr=LrSchedule(base=0.05), vote_impl=impl), make_mesh(*mesh))


ROUND_CASES = {
    "sparsign-psum": ("sparsign", "majority_vote", "psum", ((M, T), ("data", "model"))),
    "sparsign-hier": ("sparsign", "majority_vote", "hier",
                      ((2, 2, T), ("pod", "data", "model"))),
    "sparsign-packed": ("sparsign", "majority_vote", "allgather_packed",
                        ((M, T), ("data", "model"))),
    "qsgd8-pack8": ("qsgd8", "mean", "allgather_packed", ((M, T), ("data", "model"))),
    "qsgd8-decoded-psum": ("qsgd8", "mean", "psum", ((M, T), ("data", "model"))),
}


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_tp_round_matches_jax_on_whole_leaves(case):
    """Two (4, 2) rounds with injected gradients: the slices, reassembled,
    equal JAX's whole-leaf round bit for bit; wire bytes are the slice
    ledger (each device's slices, replicated leaves whole)."""
    comp_name, server, impl, mesh = ROUND_CASES[case]
    exact = comp_name == "qsgd8"   # its L2 scale: a sum of squares, exact in any order
    budget = 2.0 if comp_name == "sparsign" else 1.0
    jc = JConfig(compressor=comp_name, budget=JBudget(value=budget), server=server)
    tc = CompressionConfig(compressor=comp_name, budget=BudgetConfig(value=budget),
                           server=server)
    step = _tp_step(tc, impl, mesh)
    params, _, _ = _tp_injected(0, exact)
    state = step.shard_state(_state_of(params, server))
    for r in range(2):
        _, per, batch = _tp_injected(r + 1, exact)
        want, _ = jax_round(params, per, jc, seed=11, step=r, lr=np.float32(0.05))
        state, metrics = step(state, batch)
        got = [t.numpy().copy() for t in tree_leaves(step.whole_state(state).params)]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(f32bits(a), f32bits(b))
        assert any((a != p).any() for a, p in zip(got, params))
        assert float(metrics["wire_bytes_per_device"]) == np.float32(
            tp_slice_ledger(step, InjectedTPModel()))
        params = got


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
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import Model
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step

def run(data, impl, budget):
    model = Model(get_config("qwen1.5-4b", smoke=True))
    comp = CompressionConfig(compressor="sparsign", budget=budget, server="majority_vote")
    step = build_train_step(model, TrainStepConfig(
        compression=comp, lr=LrSchedule(base=0.05), vote_impl=impl),
        make_mesh((data, 2), ("data", "model")))
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
               "1x2": run(1, "psum", BudgetConfig(kind="l2_norm", value=0.1))}
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


@pytest.mark.parametrize("key", ["2x2", "1x2"])
def test_two_processes_equal_one(key, proc_runs):
    """(2 data x 2 model): each process holds a whole worker; (1 x 2): each
    holds one model rank, so every TP all-reduce crosses the processes. Both
    ranks' gathered parameters and the metrics equal one process's bit for
    bit (the L2 budget's sums of squares and the loss reductions are
    ordered)."""
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
    "golomb": dict(compressor="sparsign_golomb", impl="allgather_packed",
                   budget=BudgetConfig(kind="target_sparsity", value=0.05)),
    "target_sparsity": dict(budget=BudgetConfig(kind="target_sparsity", value=0.05)),
    "linf_share": dict(budget=BudgetConfig(kind="linf_share", value=1.0)),
    "scaled_sign": dict(compressor="scaled_sign", server="mean", impl="allgather_packed"),
    "sign-on-psum": dict(compressor="sign"),
    "qsgd_1bit": dict(compressor="qsgd_1bit_l2", server="mean", impl="allgather_packed"),
    "bucketed": dict(bucketed=True),
    "ring": dict(impl="allgather_packed", ring_chunk_rows=32),
    "elastic": dict(participation=ParticipationSpec(weights=(1.0, 1.0, 1.0, 1.0))),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_what_is_not_ported_under_t2_raises(case):
    kw = dict(REFUSALS[case])
    arch = kw.pop("arch", "qwen1.5-4b")
    comp = CompressionConfig(compressor=kw.pop("compressor", "sparsign"),
                             budget=kw.pop("budget", BudgetConfig(value=1.0)),
                             server=kw.pop("server", "majority_vote"))
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
    """The analysis gate's tensor-parallel census at (4, 2) on psum and
    allgather_packed: each model rank's recorded wire bytes equal the slice
    ledger, which the step reports as wire_bytes_per_device; the 'model'
    axis's own reductions are a note, not a finding."""
    from repro_torch.analysis import drivers
    findings, checks = drivers.run_tp_census_checks(device="cpu")
    assert checks == len(drivers.TP_IMPLS) * drivers.TP_T
    assert [f.severity for f in findings] == ["info"] * len(drivers.TP_IMPLS)
    assert all("reductions over 'model'" in f.message for f in findings)
    census, model, step = drivers.run_tp_step("allgather_packed", "cpu")
    assert census.tp_records() and all(r.role == "tp" for r in census.tp_records())
    assert (census.for_model_rank(0).payload_bytes()
            == drivers.tp_slice_ledger(step, model)
            < sum(r.ring_bytes() for r in census.records if r.role == "wire"))
