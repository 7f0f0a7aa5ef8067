"""The port's encoder-only path (hubert-xlarge) against the JAX package, on
the CPU: the GELU (``jax.nn.gelu``'s tanh form), the launcher's training
frames bit for bit, the model's leaves (no embedding table), its loss and
gradients (bidirectional attention, frame inputs, the GELU MLP with
biases), ``build_prefill``'s encoder probe, the serving launcher's refusal,
and the M = 1 trainer step, from JAX's parameters.

Tolerances: the GELU to 1e-6 of the largest magnitude (float32 ``tanh`` in
two libraries); the model's loss to rtol 1e-6 and its gradients to
``GRAD_RTOL`` = 1e-3 of each leaf's norm: at this size either side's float32
gradients lie up to 1.3e-4 of a leaf's norm from a float64 run of the port
(the attention's leaves), and 6.2e-5 from each other, so the gap is
rounding; frames bit for bit.
"""

import argparse

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
from repro.launch import train as jlaunch
from repro.launch.mesh import make_host_mesh as j_host_mesh
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
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import gelu
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.serve import decode as tserve
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step

GRAD_RTOL = 1e-3   # of each leaf's norm, the model's gradients (see the module's text)
MAX_FLIPS = 4      # coordinates whose sparsign vote may flip in the M = 1 step
ARCH = "hubert-xlarge"


def test_gelu_is_jax_s_tanh_form():
    x = np.linspace(-8.0, 8.0, 4001, dtype=np.float32)
    j = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    t = gelu(torch.from_numpy(x)).numpy()
    assert float(np.abs(t - j).max()) <= 1e-6 * float(np.abs(j).max())
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert float(np.abs(erf - j).max()) > 1e-4   # torch's default is another function


def _frames(tau, batch=4, seq_len=12, step=3):
    cfg, jcfg = get_config(ARCH, smoke=True), jget_config(ARCH, smoke=True)
    args = launch.parser().parse_args(["--arch", ARCH, "--batch", str(batch), "--seq-len",
                                       str(seq_len), "--seed", "5", "--tau", str(tau)])
    jargs = argparse.Namespace(batch=batch, seq_len=seq_len, seed=5, tau=tau)
    return launch.batch_fn_for(cfg, args)(step), jlaunch.batch_fn_for(jcfg, jargs)(step)


@pytest.mark.parametrize("tau", [1, 2])
def test_training_frames_equal_jax_s_bit_for_bit(tau):
    """Frames N(0, 1) cast to float32, then scaled by 0.3 (JAX's launcher's
    order), with the token labels and positions; with tau = 2 each entry
    is repeated over a leading axis."""
    got, want = _frames(tau)
    assert sorted(got) == sorted(want) == ["inputs", "labels", "positions"]
    lead = (tau,) if tau > 1 else ()
    assert got["inputs"].shape == lead + (4, 12, 64) and got["inputs"].dtype == np.float32
    for k in got:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k


@pytest.mark.parametrize("smoke", [True, False])
def test_param_leaves_match_jax(smoke):
    """12 leaves (the GELU MLP's w1 b1 w2 b2, no embedding table);
    944,794,880 parameters at full width."""
    jleaves = jax.tree_util.tree_flatten_with_path(
        JModel(jget_config(ARCH, smoke=smoke)).param_shapes())[0]
    tm = Model(get_config(ARCH, smoke=smoke))
    tleaves = tree_leaves(tm.param_shapes())
    assert len(tleaves) == len(jleaves) == 12
    for (path, j), t in zip(jleaves, tleaves):
        assert tuple(t.shape) == tuple(j.shape), jax.tree_util.keystr(path)
        assert str(t.dtype).split(".")[-1] == str(j.dtype), jax.tree_util.keystr(path)
    assert "embed" not in tm.param_shapes()
    if not smoke:
        assert tm.param_count() == 944_794_880


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
    """21 frames cross the attention chunk (16) and the loss chunk (16),
    with a masked label."""
    jm, tm, jp, tp = models
    batch, _ = _frames(1, batch=2, seq_len=21)
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


def test_encoder_probe_matches_jax(models):
    """build_prefill of an encoder-only model: the full forward's loss, no
    caches, as JAX's encoder branch computes it."""
    jm, tm, jp, tp = models
    batch, _ = _frames(1, batch=2, seq_len=19)
    j = jserve.build_prefill(jm, j_host_mesh(1, 1))(jp, {k: jnp.asarray(v)
                                                        for k, v in batch.items()})
    t = tserve.build_prefill(tm)(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert t.shape == () and t.dtype == torch.float32
    np.testing.assert_allclose(float(t), float(j), rtol=1e-6)


def test_serve_launcher_refuses_an_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        launch_serve.main(["--arch", ARCH, "--device", "cpu"])


def test_m1_train_step_matches_jax(models, capsys):
    """Two steps of JAX's build_train_step at M = 1 (allgather_packed,
    majority vote) on the launcher's frames, against the port's from the
    same weights: at most MAX_FLIPS coordinates differ (a sparsign draw
    between the two sides' rounding of a gradient)."""
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
        batch, _ = _frames(1, batch=2, seq_len=16, step=step)
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
            print(f"\n[hubert M = 1] step {step}: {differ} of {sum(a.size for a in jl)} "
                  f"coordinates differ from JAX")
        assert differ <= MAX_FLIPS
