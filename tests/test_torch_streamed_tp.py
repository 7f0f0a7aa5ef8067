"""The port's streamed (FSDP) trainer under a tensor-parallel 'model' axis,
``repro_torch.train.step_streamed`` at T = 2, on the CPU at the smoke sizes
of its three architectures (llama4-scout-17b-a16e, qwen2-vl-72b with its
``positions3``, jamba-1.5-large-398b); ``tests/test_torch_streamed_tp_jax.py``
holds it against JAX's own streamed step on a (4, 2) mesh.

(a) The layout: every leaf's (model dim, shard axis) equals the spec of
    JAX's ``streamed_shardings`` on a (4 data, 2 model) mesh, smoke and
    published configs; two processes' pieces tile each leaf, and a whole
    leaf cut and gathered comes back bit for bit.
(b) Injected gradients (``chip_smoke.injected_streamed_net``: every stage's
    backward hands each leaf a gradient made from the leaf's own values and
    the incoming cotangent by exactly rounded operations, so a model slice's
    gradient is the slice of the whole leaf's), M = 4 x T = 2 against T = 1 from one
    state, two rounds: fixed sparsign with majority vote on psum, on the
    2-bit gather, bucketed (one bucket and 1 KiB buckets) and under elastic
    participation 0 coordinates apart; ``sparsign_golomb`` under
    ``target_sparsity`` within ``test_torch_tp``'s float-sum flip bound,
    nothing dropped; ``scaled_sign_ef`` to rtol 1e-6 with the same
    coordinates moving. Wire bytes are the slice ledger
    (``analysis.drivers.tp_slice_ledger``).
(c) The model's own float32 gradients through the streamed stages at T = 2
    against T = 1 (``GRAD_RTOL``, jamba ``GRAD_RTOL_DEEP``); the streamed
    T = 2 step equals the simple T = 2 step (``step_tp``) bit for bit at one
    repeat.
(d) The launcher's ``--mode streamed --host-model 2`` (also ``--bucketed``),
    a checkpoint saved at (4, 2) resumed at (4, 2) bit for bit and restored
    at (2, 1) and (4, 2), two gloo processes the same bits as one.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models.model import Model as JModel
from repro.train import step_streamed as jss
from repro_torch.analysis.drivers import tp_slice_ledger
from repro_torch.configs.registry import get_config
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.dist.collectives import ModelGroup, ParticipationSpec, WorkerGroup
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import step_streamed as tss
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step
from test_torch_streamed import _batch
from test_torch_tp import GRAD_RTOL, GRAD_RTOL_DEEP, LOSS_RTOL, _free_port, f32bits, float_flips

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("llama4-scout-17b-a16e", "qwen2-vl-72b", "jamba-1.5-large-398b")
M, T = 4, 2
WEIGHTS = (1.5, 0.5, 2.0, 1.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------- (a) layout

def _jax_axes(spec, ndim):
    """(the dim a JAX spec puts on 'model', the dim it puts on 'data')."""
    entries = list(spec) + [None] * (ndim - len(spec))

    def dim_of(name):
        hits = [i for i, e in enumerate(entries) if e == name
                or (isinstance(e, tuple) and name in e)]
        return hits[0] if hits else None

    data = dim_of("data")
    return dim_of("model"), tss.REPLICATED if data is None else data


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_matches_jax_streamed_shardings(arch):
    """Each leaf's model dim and shard axis against the merged spec of JAX's
    ``streamed_shardings`` on an abstract (4 data, 2 model) mesh."""
    import jax
    from jax.sharding import AbstractMesh
    mesh = AbstractMesh((M, T), ("data", "model"))
    for smoke in (True, False):
        named, _, _ = jss.streamed_shardings(JModel(jget_config(arch, smoke=smoke)), mesh)
        specs = jax.tree_util.tree_leaves(named, is_leaf=lambda x: hasattr(x, "spec"))
        model = Model(get_config(arch, smoke=smoke))
        lays = tree_leaves(tss.streamed_layout(model, make_host_mesh(M, T)))
        assert len(specs) == len(lays)
        for sh, lay in zip(specs, lays):
            want = _jax_axes(sh.spec, len(lay.shape))
            assert (lay.tp_dim, lay.axis) == want, (arch, smoke, lay, sh.spec)
            assert lay.tp_dim is None or lay.ranks == (0, 1) and lay.parts == T


def test_two_processes_pieces_tile_each_leaf_and_gather_back():
    """Process r of two holds workers 2r, 2r + 1 with both model ranks: the
    shard axis cuts each model slice as at T = 1; cut and gathered in one
    process, every leaf comes back bit for bit."""
    model = Model(get_config("jamba-1.5-large-398b", smoke=True))
    per = [tree_leaves(tss.streamed_layout(model, WorkerGroup(
        ("data",), (M,), rank=r, world=2, model=ModelGroup(T)))) for r in range(2)]
    for a, b in zip(*per):
        assert (a.tp_dim, a.axis, a.ranks) == (b.tp_dim, b.axis, b.ranks)
        if a.axis != tss.REPLICATED:
            assert (a.start, b.start, a.size + b.size) == (0, a.size, a.shape[a.axis])
    group = make_host_mesh(M, T)
    layout = tss.streamed_layout(model, group)
    params = model.init(0, device="cpu")
    back = tss.gather_tree(tss.shard_tree(dict(params, blocks=tuple(
        dict(b) for b in params["blocks"])), layout), layout, group)
    for x, y in zip(tree_leaves(params), tree_leaves(back)):
        assert torch.equal(x, y)


# ------------------------------------------------------- (b) injected rounds

def injected(arch):
    """``chip_smoke.injected_streamed_net`` on the smoke config: the same
    stages the card's S2T runs inject through."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke.injected_streamed_net(torch, Model(get_config(arch, smoke=True)))


ROUND_CASES = {
    # case -> (compressor, server, vote_impl, budget kind, value, step options)
    "psum": ("sparsign", "majority_vote", "psum", "fixed", 2.0, {}),
    "pack2": ("sparsign", "majority_vote", "allgather_packed", "fixed", 2.0, {}),
    "bucketed": ("sparsign", "majority_vote", "allgather_packed", "fixed", 2.0,
                 {"bucketed": True}),
    "bucketed_1k": ("sparsign", "majority_vote", "allgather_packed", "fixed", 2.0,
                    {"bucketed": True, "bucket_bytes": 1024}),
    "elastic_pack2": ("sparsign", "majority_vote", "allgather_packed", "fixed", 2.0,
                      {"participation": ParticipationSpec(weights=WEIGHTS, dropout=0.25)}),
    # a layer's coded message has a layer's capacity: the plan fraction
    # leaves room above the realized density (test_torch_streamed's)
    "golomb": ("sparsign_golomb", "majority_vote", "allgather_packed", "target_sparsity", 0.05,
               {"golomb_p": 0.2}),
    "ef": ("sparsign", "scaled_sign_ef", "psum", "fixed", 2.0, {}),
}


def _round_runs(arch, case):
    """Two rounds at (4, 2) and at (4, 1) from one state: (T = 2's whole
    leaves and last metrics, T = 1's, the first leaves, T = 2's step, the
    model)."""
    compressor, server, impl, kind, value, kw = ROUND_CASES[case]
    net = injected(arch)
    comp = CompressionConfig(compressor=compressor, budget=BudgetConfig(kind=kind, value=value),
                             server=server)
    p0 = net.init(0, "cpu")
    out = []
    for t in (T, 1):
        step = tss.build_streamed_train_step(net, tss.StreamedStepConfig(
            compression=comp, lr=LrSchedule(base=0.05), vote_impl=impl, **kw),
            make_host_mesh(M, t))
        state = step.shard_state(init_state(tree_unflatten(p0, [x.clone() for x in
                                                                tree_leaves(p0)]),
                                            server=server, seed=3))
        for r in range(2):
            state, m = step(state, _batch(net.cfg, r))
        whole = step.whole_state(state)
        leaves = [x.numpy().copy() for x in tree_leaves(whole.params)]
        if whole.ef_residual is not None:
            leaves += [x.numpy().copy() for x in tree_leaves(whole.ef_residual)]
        out.append((leaves, {k: float(v) for k, v in m.items()}, step))
    (a, ma, step2), (b, mb, _) = out
    return a, ma, b, mb, [x.numpy() for x in tree_leaves(p0)], step2, net


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_injected_t2_against_t1(arch, case, capsys):
    a, ma, b, mb, p0, step, net = _round_runs(arch, case)
    assert ma["wire_bytes_per_device"] == np.float32(tp_slice_ledger(step, net))
    assert ma["wire_bytes_per_device"] == np.float32(step.ledger[0])
    assert ma["loss"] == mb["loss"] and ma["participated"] == mb["participated"]
    assert ma.get("nnz_dropped", 0.0) == mb.get("nnz_dropped", 0.0) == 0.0
    n_par = len(p0)
    bits = sum(int((f32bits(x) != f32bits(y)).sum()) for x, y in zip(a, b))
    moved = sum(int((x != p).sum()) for x, p in zip(a[:n_par], p0))
    size = sum(x.size for x in a[:n_par])
    with capsys.disabled():
        print(f"\n[{arch} streamed (4, 2) vs (4, 1), {case}] {bits} coordinates apart in any "
              f"bit, {moved} of {size} moved")
    assert moved > 0
    if case == "golomb":   # the bisection's sums in rank order: test_torch_tp's bound
        assert float_flips(a[:n_par], b[:n_par], p0) <= 1e-4 * size
    elif case == "ef":     # the L1's sums in rank order: test_torch_tp's EF bound
        for x, y, p in zip(a[:n_par], b[:n_par], p0):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(x != p, y != p)
        for x, y in zip(a[n_par:], b[n_par:]):
            np.testing.assert_allclose(x, y, rtol=1e-6,
                                       atol=1e-6 * max(float(np.abs(y).max()), 1e-30))
    else:
        assert bits == 0


# ------------------------------------------------- (c) the model's gradients

def _staged_loss_grads(net, params, batch, block_lays=None):
    """The loss and the parameter gradients through the streamed stages:
    ``embed_stage``, ``superblock_apply`` a repeat (under T, a cut leaf as
    its ranks' slices of the layer, ``block_lays`` its layouts),
    ``head_loss`` on the final norm."""
    from repro_torch.models.common import rms_norm
    cfg = net.cfg
    leaves = [x.detach().clone().requires_grad_(True) for x in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    h = net.embed_stage(p, batch)
    pos, pos3 = batch["positions"], batch.get("positions3")
    blocks = tree_leaves(p["blocks"])
    lays = block_lays or [None] * len(blocks)
    for l in range(cfg.n_repeats):
        layer = tree_unflatten(p["blocks"], [x[:, l] if lay is not None and lay.tp else x[l]
                                             for x, lay in zip(blocks, lays)])
        h = net.superblock_apply(layer, h, pos, pos3)
    loss = net.head_loss(p, rms_norm(h, p["final_norm"], cfg.norm_eps), batch["labels"])
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_gradients_through_the_stages_t2_against_t1(arch):
    """float32, 2 x 16 tokens: the loss to ``LOSS_RTOL`` and each leaf's
    reassembled gradient to ``GRAD_RTOL`` of its norm (jamba's 8-layer
    pattern ``GRAD_RTOL_DEEP``), as ``test_torch_tp`` holds the whole
    model."""
    model = Model(get_config(arch, smoke=True))
    group = make_host_mesh(M, T)
    layout = tree_leaves(tss.streamed_layout(model, group))
    params = model.init(0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg, 0, b=2).items()}
    tp_params = tree_unflatten(params, [torch.stack(x.chunk(T, lay.tp_dim)) if lay.tp else x
                                        for x, lay in zip(tree_leaves(params), layout)])
    loss1, g1 = _staged_loss_grads(model, params, batch)
    loss2, g2 = _staged_loss_grads(model.tensor_parallel(group.model), tp_params, batch,
                                   tree_leaves(tss.streamed_layout(model, group)["blocks"]))
    np.testing.assert_allclose(loss2, loss1, rtol=LOSS_RTOL)
    rtol = GRAD_RTOL_DEEP.get(arch, GRAD_RTOL)
    for a, b, lay in zip(g2, g1, layout):
        a = torch.cat(list(a.unbind(0)), dim=lay.tp_dim) if lay.tp else a
        assert float(torch.linalg.vector_norm(a - b)) <= rtol * float(
            torch.linalg.vector_norm(b)) + 1e-12, (arch, lay)


@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_t2_equals_simple_t2_at_one_repeat(arch):
    """The model's own gradients, fixed sparsign on the 2-bit gather, one
    step at one repeat: the streamed T = 2 step and ``step_tp``'s bit for
    bit (the same stages in the same order)."""
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    model = Model(cfg)
    comp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                             server="majority_vote")
    lr, group = LrSchedule(base=0.05), make_host_mesh(M, T)
    got = []
    for step in (tss.build_streamed_train_step(model, tss.StreamedStepConfig(
            compression=comp, lr=lr, vote_impl="allgather_packed"), group),
                 build_train_step(model, TrainStepConfig(
                     compression=comp, lr=lr, vote_impl="allgather_packed"), group)):
        state = step.shard_state(init_state(model.init(0, "cpu"), server=comp.server, seed=3))
        state, m = step(state, _batch(cfg, 0))
        got.append(([x.clone() for x in tree_leaves(step.whole_state(state).params)],
                    float(m["loss"])))
    (a, la), (b, lb) = got
    assert la == lb
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


# --------------------------------------- (d) launcher, checkpoints, processes

LAUNCH = ["--device", "cpu", "--host-data", "4", "--host-model", "2", "--batch", "4",
          "--vote-impl", "allgather_packed", "--server", "majority_vote", "--mode", "streamed"]


@pytest.mark.parametrize("arch,extra", [("llama4-scout-17b-a16e", []),
                                        ("qwen2-vl-72b", ["--bucketed"])])
def test_launcher_runs_streamed_under_host_model_2(arch, extra):
    args = launch.parser().parse_args(["--arch", arch, "--steps", "1", "--seq-len", "16"]
                                      + LAUNCH + extra)
    cfg, model, group, step, state, _ = launch.build_everything(args)
    assert group.model_size == T and hasattr(step, "layout")
    assert (step.plans[0] is not None) == ("--bucketed" in extra)
    state, m = step(state, launch.batch_fn_for(cfg, args)(0))
    assert np.isfinite(float(m["loss"]))
    assert float(m["wire_bytes_per_device"]) == np.float32(tp_slice_ledger(step, model))


def _whole_leaves(step, state):
    w = step.whole_state(state)
    return tree_leaves(w.params) + tree_leaves(w.ef_residual)


def test_checkpoint_at_4x2_resumes_and_restores_across_layouts(tmp_path):
    """An EF run at (4, 2): the state after one step, saved whole, resumed
    at (4, 2) gives the straight run's second step bit for bit; it restores
    at (2, 1) and at (4, 2) onto their pieces, every leaf bit for bit."""
    net = injected("qwen2-vl-72b")
    comp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                             server="scaled_sign_ef")

    def build(d, t):
        return tss.build_streamed_train_step(net, tss.StreamedStepConfig(
            compression=comp, lr=LrSchedule(base=0.05), vote_impl="psum"),
            make_host_mesh(d, t))

    s42 = build(M, T)
    state = s42.shard_state(init_state(net.init(0, "cpu"), server=comp.server, seed=3))
    state, _ = s42(state, _batch(net.cfg, 0))
    whole, write = s42.checkpoint_state(state)
    assert write
    ckpt.save(str(tmp_path), 1, whole)
    saved = [x.clone() for x in tree_leaves(whole.params) + tree_leaves(whole.ef_residual)]
    state, _ = s42(state, _batch(net.cfg, 1))
    straight = [x.clone() for x in _whole_leaves(s42, state)]
    for d, t in ((M, T), (2, 1)):
        step = build(d, t)
        mine = step.shard_state(init_state(net.init(1, "cpu"), server=comp.server, seed=3))
        back, _ = ckpt.restore(str(tmp_path), mine, shardings=step.state_shardings(mine))
        for x, y in zip(_whole_leaves(step, back), saved):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        if t == T:
            back, _ = step(back, _batch(net.cfg, 1))
            for x, y in zip(_whole_leaves(step, back), straight):
                assert torch.equal(x.view(torch.int32), y.view(torch.int32))


CHILD = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import tree_leaves
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import Model
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_streamed import StreamedStepConfig, build_streamed_train_step

def batch(cfg, r):
    rng = np.random.RandomState(r)
    b = {"inputs": rng.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32),
         "labels": rng.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32),
         "positions": np.broadcast_to(np.arange(16, dtype=np.int32), (4, 16)).copy()}
    if cfg.input_kind != "tokens":
        b["inputs"] = (rng.randn(4, 16, cfg.d_model) * 0.3).astype(np.float32)
    if cfg.mrope:
        b["positions3"] = np.broadcast_to(b["positions"][..., None], (4, 16, 3)).copy()
    return b

def run(arch, impl, server, bucketed):
    model = Model(get_config(arch, smoke=True))
    comp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                             server=server)
    step = build_streamed_train_step(model, StreamedStepConfig(
        compression=comp, lr=LrSchedule(base=0.05), vote_impl=impl, bucketed=bucketed),
        make_mesh((4, 2), ("data", "model")))
    state = step.shard_state(init_state(model.init(0, device="cpu"), server=server, seed=3))
    for r in range(2):
        state, metrics = step(state, batch(model.cfg, r))
    whole = step.whole_state(state)
    return {"leaves": [t.clone() for t in tree_leaves(whole.params)
                       + tree_leaves(whole.ef_residual)],
            "metrics": {k: float(v) for k, v in metrics.items()}}

if __name__ == "__main__":
    rank, world, port, out = sys.argv[1:]
    if int(world) > 1:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=int(rank), world_size=int(world))
    try:
        res = {"pack2": run("llama4-scout-17b-a16e", "allgather_packed", "majority_vote", True),
               "ef": run("qwen2-vl-72b", "psum", "scaled_sign_ef", False)}
        torch.save(res, out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def proc_runs(tmp_path_factory):
    """One process holding the (4, 2) mesh, and two gloo processes of two
    whole workers each, at once."""
    tmp = tmp_path_factory.mktemp("streamed_tp_dist")
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


@pytest.mark.parametrize("key", ["pack2", "ef"])
def test_two_processes_equal_one(key, proc_runs):
    """llama4-scout bucketed on the 2-bit gather and qwen2-vl-72b with the EF
    server on psum (its L1 gathered over the processes), the model's own
    gradients: both processes' gathered leaves and the metrics equal one
    process's bit for bit."""
    one, two = proc_runs
    for res in two:
        for a, b in zip(res[key]["leaves"], one[key]["leaves"]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert res[key]["metrics"] == one[key]["metrics"]
