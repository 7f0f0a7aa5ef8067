"""The port's checkpoints, resume and failure injection, on the CPU:

(a) the JAX package's checkpoint and loop tests (``tests/test_substrate.py``)
    mirrored on the port: a round trip with a bf16 leaf, rotation, structure
    mismatch, shape and dtype drift, the stale-checkpoint warning, the newest
    compatible checkpoint past a stale shadow, no ``.tmp`` left;
(b) the on-disk format against JAX's, for qwen1.5-4b smoke with and without
    a server EF residual and mamba2-370m smoke in bf16: the port's leaf
    descriptors and fingerprint equal JAX's for the same state, a checkpoint
    ``repro.train.checkpoint.save`` wrote restores in the port bit for bit,
    and one the port wrote restores in JAX bit for bit;
(c) checks 1-2 of ``tests/mdev/check_fault_tolerance.py`` on the port: 8
    straight steps against a run that checkpoints every 2, dies at step 5
    and resumes, bit for bit; then the checkpoint resumed at M = 2 through
    the launcher.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.data.synthetic import LMStreamConfig as JStream
from repro.data.synthetic import lm_stream as j_lm_stream
from repro.models.model import Model as JModel
from repro.train import checkpoint as jckpt
from repro.train.state import init_state as j_init_state
from repro_torch.configs.registry import get_config
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.data.synthetic import LMStreamConfig, lm_batch, lm_stream
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as loop_lib
from repro_torch.train.state import LrSchedule, TrainState, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step


def bits(t):
    t = torch.as_tensor(t)
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}.get(t.dtype, t.dtype))


def same_state(a, b) -> bool:
    la, lb = tree_leaves([a.params, a.ef_residual]), tree_leaves([b.params, b.ef_residual])
    return (len(la) == len(lb) and a.step == b.step and a.seed == b.seed
            and all(x.dtype == y.dtype and torch.equal(bits(x), bits(y)) for x, y in zip(la, lb)))


# --------------------------------------------------- (a) the mirrored tests

def _tiny_state(seed=0):
    rng = np.random.RandomState(seed)
    return TrainState(
        params={"a": torch.from_numpy(rng.randn(4, 8).astype(np.float32)),
                "b": (torch.from_numpy(rng.randn(3).astype(np.float32)).to(torch.bfloat16),)},
        ef_residual=None, step=7, seed=42)


def test_checkpoint_roundtrip(tmp_path):
    state = _tiny_state()
    ckpt.save(str(tmp_path), 7, state)
    restored, manifest = ckpt.restore(str(tmp_path), state)
    assert manifest["step"] == 7
    assert same_state(state, restored)
    assert restored.params["b"][0].dtype == torch.bfloat16
    assert type(restored.step) is int and type(restored.seed) is int


def test_checkpoint_rotation_and_latest(tmp_path):
    state = _tiny_state()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, state, keep=2)
    assert ckpt.latest_steps(str(tmp_path)) == [4, 5]


def test_checkpoint_structure_mismatch_rejected(tmp_path):
    state = _tiny_state()
    ckpt.save(str(tmp_path), 1, state)
    other = dataclasses.replace(state, params={"a": state.params["a"]})
    with pytest.raises(ckpt.CheckpointMismatchError, match="different model"):
        ckpt.restore(str(tmp_path), other)


def test_checkpoint_fingerprint_catches_shape_and_dtype_drift(tmp_path):
    """Same tree structure, another leaf shape or dtype: a loud mismatch."""
    state = _tiny_state()
    ckpt.save(str(tmp_path), 1, state)
    reshaped = dataclasses.replace(state, params={"a": torch.zeros(8, 4), "b": state.params["b"]})
    with pytest.raises(ckpt.CheckpointMismatchError):
        ckpt.restore(str(tmp_path), reshaped)
    retyped = dataclasses.replace(state, params={"a": state.params["a"].to(torch.bfloat16),
                                                 "b": state.params["b"]})
    with pytest.raises(ckpt.CheckpointMismatchError):
        ckpt.restore(str(tmp_path), retyped)
    # a matching state still round-trips, and the manifest carries the print
    restored, manifest = ckpt.restore(str(tmp_path), state)
    assert manifest["fingerprint"] == ckpt.tree_fingerprint(state)


def _counting_step(calls):
    def fake_step(state, batch):
        calls.append(state.step)
        return dataclasses.replace(state, step=state.step + 1), {"loss": torch.tensor(0.0)}
    return fake_step


def test_loop_skips_stale_checkpoint_with_warning(tmp_path):
    """The loop does not resume from a checkpoint another model config wrote
    into the same directory: it warns and starts fresh."""
    ckpt.save(str(tmp_path), 5, _tiny_state())
    fresh = TrainState(params={"w": torch.zeros(3, 3)}, ef_residual=None, step=0, seed=0)
    calls, logs = [], []
    cfg = loop_lib.LoopConfig(total_steps=2, ckpt_dir=str(tmp_path), ckpt_every=0, log_every=1)
    out, history = loop_lib.run(_counting_step(calls), fresh, lambda i: {}, cfg,
                                log=logs.append)
    assert calls == [0, 1], calls
    assert any("WARNING" in line for line in logs), logs
    assert out.step == 2


def test_loop_resumes_newest_compatible_past_stale_shadow(tmp_path):
    """A stale high-step checkpoint does not shadow this run's own at lower
    steps: resume picks the newest compatible one."""
    ckpt.save(str(tmp_path), 500, _tiny_state())
    own = TrainState(params={"w": torch.ones(2, 2)}, ef_residual=None, step=30, seed=0)
    ckpt.save(str(tmp_path), 30, own)
    like = TrainState(params={"w": torch.zeros(2, 2)}, ef_residual=None, step=0, seed=0)
    calls, logs = [], []
    cfg = loop_lib.LoopConfig(total_steps=32, ckpt_dir=str(tmp_path), ckpt_every=0, log_every=1)
    out, _ = loop_lib.run(_counting_step(calls), like, lambda i: {}, cfg, log=logs.append)
    assert calls == [30, 31], calls
    assert any("skipping checkpoint step_00000500" in line for line in logs), logs
    assert float(out.params["w"][0, 0]) == 1.0


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    ckpt.save(str(tmp_path), 3, _tiny_state())
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


# ------------------------------------------------- (b) the format vs JAX's

FORMAT_CASES = [pytest.param("qwen1.5-4b", "majority_vote", "float32", id="qwen-no-ef"),
                pytest.param("qwen1.5-4b", "scaled_sign_ef", "float32", id="qwen-ef"),
                pytest.param("mamba2-370m", "scaled_sign_ef", "bfloat16", id="mamba2-bf16-ef")]


def _both_states(arch, server, dtype):
    """The same state in both packages: parameters and an EF residual of
    random numpy values in JAX's tree, step 3, a seed above 2^31."""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), dtype=dtype)
    rng = np.random.RandomState(4)
    jp = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape), x.dtype),
        JModel(jcfg).init(jax.random.PRNGKey(2)))
    jstate = j_init_state(jp, server=server, seed=0xFEEDBEEF)
    if jstate.ef_residual is not None:
        jstate.ef_residual = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.randn(*x.shape), jnp.float32), jstate.ef_residual)
    jstate.step = jnp.int32(3)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tstate = TrainState(params=params_from_numpy(to_np(jstate.params)),
                        ef_residual=(None if jstate.ef_residual is None
                                     else params_from_numpy(to_np(jstate.ef_residual))),
                        step=3, seed=0xFEEDBEEF)
    return jstate, tstate


def _jleaves(jstate):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]


def _tleaves(tstate):
    out = []
    for _, leaf in ckpt._flatten_with_path(tstate):
        t = torch.as_tensor(leaf)
        out.append(t.to(torch.float32).numpy() if t.dtype == torch.bfloat16 else t.numpy())
    return out


def _equal_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a.shape == b.shape and a.tobytes() == np.asarray(b, a.dtype).tobytes()


@pytest.mark.parametrize("arch,server,dtype", FORMAT_CASES)
def test_manifest_matches_jax(arch, server, dtype, tmp_path):
    """Paths, shapes, dtypes and fingerprint equal JAX's; the port's
    manifest equals the one JAX writes for the same state, and each leaf's
    .npy file is the same bytes."""
    jstate, tstate = _both_states(arch, server, dtype)
    assert ckpt._leaf_descs(tstate) == jckpt._leaf_descs(jstate)
    assert ckpt.tree_fingerprint(tstate) == jckpt.tree_fingerprint(jstate)
    # JAX drops ef_residual=None from the tree: parameters (and residuals), step, seed
    n_params = len(jax.tree_util.tree_leaves(jstate.params))
    assert len(ckpt._leaf_descs(tstate)) == n_params * (1 if server == "majority_vote" else 2) + 2
    jdir, tdir = jckpt.save(str(tmp_path / "j"), 3, jstate), ckpt.save(str(tmp_path / "t"), 3,
                                                                       tstate)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as f, open(os.path.join(tdir, name), "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize("arch,server,dtype", FORMAT_CASES)
def test_checkpoints_restore_across_packages(arch, server, dtype, tmp_path):
    """A checkpoint JAX saved restores in the port bit for bit (bf16 leaves
    narrowed from float32, step and seed as ints), and one the port saved
    restores in JAX bit for bit."""
    jstate, tstate = _both_states(arch, server, dtype)
    jckpt.save(str(tmp_path / "j"), 3, jstate)
    like = init_state(Model(dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))
                      .init(0, "cpu"), server=server, seed=0)
    got, manifest = ckpt.restore(str(tmp_path / "j"), like)
    assert manifest["step"] == 3 and got.step == 3 and got.seed == 0xFEEDBEEF
    assert same_state(got, tstate)

    ckpt.save(str(tmp_path / "t"), 3, tstate)
    jlike = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    jgot, _ = jckpt.restore(str(tmp_path / "t"), jlike)
    for a, b in zip(_jleaves(jgot), _jleaves(jstate)):
        assert a.dtype == b.dtype and _equal_bits(a, b)
    for a, b in zip(_tleaves(tstate), _jleaves(jstate)):
        assert _equal_bits(b, a)


def test_restore_refuses_shardings(tmp_path):
    """Shardings that are not a streamed layout (``LeafLayout`` leaves in
    the state's structure) are refused."""
    state = _tiny_state()
    ckpt.save(str(tmp_path), 1, state)
    with pytest.raises(TypeError, match="state_shardings"):
        ckpt.restore(str(tmp_path), state, shardings=object())
    with pytest.raises(TypeError, match="LeafLayout"):
        ckpt.restore(str(tmp_path), state, shardings=dataclasses.replace(
            state, params=tree_unflatten(state.params, [object()] * len(
                tree_leaves(state.params)))))


def test_lm_stream_and_batches_from_fn_replay_the_steps():
    """lm_stream equals JAX's, batch for batch, and batches_from_fn resumes
    at any step with the same batches."""
    cfg = LMStreamConfig(vocab_size=256, seq_len=8, global_batch=2, seed=3)
    jax_stream = j_lm_stream(JStream(vocab_size=256, seq_len=8, global_batch=2, seed=3), 2)
    stream = lm_stream(cfg, 2)
    resumed = loop_lib.batches_from_fn(lambda i: lm_batch(cfg, i), 2)
    for _ in range(3):
        a, b, c = next(jax_stream), next(stream), next(resumed)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(b[k], c[k])


# ----------------------------- (c) check_fault_tolerance.py, checks 1 and 2

def _ft_setup():
    """check_fault_tolerance.py's setup on the port: qwen1.5-4b smoke,
    sparsign (budget 2) with the scaled-sign EF server, M = 4, seed 77."""
    model = Model(get_config("qwen1.5-4b", smoke=True))
    comp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                             server="scaled_sign_ef")
    step = build_train_step(model, TrainStepConfig(compression=comp, lr=LrSchedule(base=0.01)),
                            make_host_mesh(4))
    state = init_state(model.init(0, "cpu"), server=comp.server, seed=77)
    stream = LMStreamConfig(vocab_size=256, seq_len=16, global_batch=8, seed=3)
    return step, state, lambda i: lm_batch(stream, i)


def test_crash_restart_is_bitwise_and_resumes_at_another_m(tmp_path):
    step, state, batch_fn = _ft_setup()
    ref, _ = loop_lib.run(step, state, batch_fn, loop_lib.LoopConfig(total_steps=8,
                                                                     log_every=100))
    d = str(tmp_path / "ck")
    step, state, batch_fn = _ft_setup()
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        loop_lib.run(step, state, batch_fn, loop_lib.LoopConfig(
            total_steps=8, ckpt_dir=d, ckpt_every=2, fail_at_step=5, log_every=100))
    assert ckpt.latest_steps(d) == [2, 4]
    step, state, batch_fn = _ft_setup()   # fresh everything, as after a lost process
    logs = []
    got, _ = loop_lib.run(step, state, batch_fn, loop_lib.LoopConfig(
        total_steps=8, ckpt_dir=d, ckpt_every=2, log_every=100), log=logs.append)
    assert "[loop] resumed from step 4" in logs[0], logs
    assert got.ef_residual is not None and same_state(got, ref)

    # the elastic restore through the launcher: the step-8 checkpoint at M = 2
    state10, history = launch.main([
        "--arch", "qwen1.5-4b", "--device", "cpu", "--host-data", "2", "--batch", "8",
        "--seq-len", "16", "--steps", "10", "--seed", "77", "--compressor", "sparsign",
        "--budget", "2.0", "--server", "scaled_sign_ef", "--lr", "0.01", "--warmup", "0",
        "--ckpt-dir", d, "--ckpt-every", "100"])
    assert state10.step == 10 and ckpt.latest_steps(d)[-1] == 10
    assert [h["step"] for h in history] == [9] and np.isfinite(history[-1]["loss"])
    assert history[-1]["participated"] == 2.0


# ------------------------------------- (e) restore onto the streamed layout

def _streamed_like(arch, server, dtype, rank, world):
    """The port's streamed state of ``arch`` for rank ``rank`` of ``world``
    processes of 4 workers: zeros of this process's slices, and the layout."""
    from repro_torch.dist.collectives import WorkerGroup
    from repro_torch.train import step_streamed

    model = Model(dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))
    layout = step_streamed.streamed_layout(
        model, WorkerGroup(("data",), (4,), rank=rank, world=world))
    state = step_streamed.shard_state(init_state(model.init(0, "cpu"), server=server, seed=0),
                                      layout)
    return state, step_streamed.state_shardings(layout, state), layout


@pytest.mark.parametrize("source", ["port", "jax"])
def test_streamed_state_restores_onto_two_processes_slices(source, tmp_path):
    """A whole state saved by one process (the port's, or JAX's ``save``)
    restores onto each rank of two processes of two workers as that rank's
    slices, which tile the saved leaves; the EF residual likewise, in
    bfloat16 parameters narrowed from the file's float32."""
    arch, server, dtype = "llama4-scout-17b-a16e", "scaled_sign_ef", "bfloat16"
    jstate, tstate = _both_states(arch, server, dtype)
    if source == "jax":
        jckpt.save(str(tmp_path), 3, jstate)
    else:
        ckpt.save(str(tmp_path), 3, tstate)
    parts = []
    for rank in range(2):
        like, shardings, layout = _streamed_like(arch, server, dtype, rank, 2)
        got, manifest = ckpt.restore(str(tmp_path), like, shardings=shardings)
        assert manifest["step"] == 3 and got.step == 3 and got.seed == 0xFEEDBEEF
        for tree in ("params", "ef_residual"):
            for x, y, lay in zip(tree_leaves(getattr(got, tree)),
                                 tree_leaves(getattr(tstate, tree)), tree_leaves(layout)):
                assert x.dtype == y.dtype and torch.equal(bits(x), bits(lay.cut(y)))
        parts.append(got)
    sharded = 0
    for a, b, whole, lay in zip(tree_leaves(parts[0].params), tree_leaves(parts[1].params),
                                tree_leaves(tstate.params),
                                tree_leaves(_streamed_like(arch, server, dtype, 0, 2)[2])):
        if lay.whole:
            assert torch.equal(bits(a), bits(b))
            continue
        sharded += 1
        assert torch.equal(bits(torch.cat([a, b], dim=lay.axis)), bits(whole))
    assert sharded >= 10
    # one process of 4 holds every leaf whole: the plain restore's state
    like, shardings, _ = _streamed_like(arch, server, dtype, 0, 1)
    assert same_state(ckpt.restore(str(tmp_path), like, shardings=shardings)[0], tstate)
