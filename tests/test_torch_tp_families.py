"""The port's T = 2 step on the MoE and mamba2 families against JAX's own
mesh step: ``repro.train.step_simple.build_train_step`` on a (4 data, 2
model) mesh of 8 forced host devices, run once in a subprocess (this file
run as a script), for the qwen2-moe-a2.7b and mamba2-370m smoke models,
against the port at ``make_host_mesh(4, 2)`` and ``make_host_mesh(4, 1)``
from the same parameters, carried across.

JAX places the routed experts on 'model' (expert parallelism) and the
mixer's d_inner leaves on 'model' by GSPMD; the port runs
``models.tensor_parallel.TPModel``'s expert-parallel FFN and head-split
mixer. The criterion is ``tests/test_torch_tp_jax_mesh.py``'s: the port's
T = 2 parameters differ from JAX's mesh step in no more coordinates than
the port's T = 1 parameters do, both counts printed, and the port's T = 1
parameters equal JAX's in every coordinate. Cases: sparsign at a
fixed B with majority vote on psum, and ``sparsign_golomb`` under
``target_sparsity`` 0.05 on allgather_packed (no nonzero dropped). JAX's
wire bytes, the whole leaves' ledger, equal the port's T = 1; the losses
agree.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# seconds: a guard on the JAX subprocess (four mesh-step compilations, about
# 40 s alone, more beside other test workers)
CHILD_TIMEOUT = 300
SEED, LR, BATCH, SEQ = 1234, 0.01, 8, 16
ARCHS = ("qwen2-moe-a2.7b", "mamba2-370m")
#: name: (compressor, budget kind, budget value, vote_impl)
CASES = {"sparsign-fixed-psum": ("sparsign", "fixed", 2.0, "psum"),
         "golomb-target_sparsity": ("sparsign_golomb", "target_sparsity", 0.05,
                                    "allgather_packed")}


def make_batch(vocab: int) -> dict:
    """``check_step_simple.make_batch``: inputs and labels from seed 0."""
    rng = np.random.RandomState(0)
    return {"inputs": rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int32),
            "labels": rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int32),
            "positions": np.broadcast_to(np.arange(SEQ), (BATCH, SEQ)).astype(np.int32)}


def _jax_runs(out_path: str) -> None:
    """The subprocess: JAX's step on the (4, 2) mesh, one step an (arch,
    case), from ``PRNGKey(0)``'s parameters; writes the initial and the
    updated parameters and the metrics."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config
    from repro.core.algorithm import CompressionConfig
    from repro.core.budgets import BudgetConfig
    from repro.dist import compat
    from repro.models.model import Model
    from repro.train.state import LrSchedule, init_state
    from repro.train.step_simple import TrainStepConfig, build_train_step

    assert jax.device_count() == 8, jax.device_count()
    mesh = compat.make_mesh((4, 2), ("data", "model"))
    out = {}
    for arch in ARCHS:
        model = Model(get_config(arch, smoke=True))
        params = model.init(jax.random.PRNGKey(0))
        batch = {k: jnp.asarray(v) for k, v in make_batch(model.cfg.vocab_size).items()}
        for i, x in enumerate(jax.tree_util.tree_leaves(params)):
            out[f"{arch}/p0/{i}"] = np.asarray(x)
        for name, (comp, kind, value, impl) in CASES.items():
            cc = CompressionConfig(compressor=comp, budget=BudgetConfig(kind=kind, value=value),
                                   server="majority_vote")
            step = build_train_step(model, TrainStepConfig(
                compression=cc, lr=LrSchedule(base=LR), worker_axes=("data",), donate=False,
                vote_impl=impl), mesh)
            with compat.set_mesh(mesh):
                state, metrics = step(init_state(params, server=cc.server, seed=SEED), batch)
            for i, x in enumerate(jax.tree_util.tree_leaves(state.params)):
                out[f"{arch}/{name}/p1/{i}"] = np.asarray(x)
            for k, v in metrics.items():
                out[f"{arch}/{name}/m/{k}"] = np.asarray(v)
    np.savez(out_path, **out)


if __name__ == "__main__":   # the subprocess
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    _jax_runs(sys.argv[1])
    sys.exit(0)


import torch  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.algorithm import CompressionConfig  # noqa: E402
from repro_torch.core.budgets import BudgetConfig  # noqa: E402
from repro_torch.core.compressors import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.train.state import LrSchedule, init_state  # noqa: E402
from repro_torch.train.step_simple import TrainStepConfig, build_train_step  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_families") / "jax_mesh.npz"
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(out.parent)), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env, capture_output=True,
                          text=True, timeout=CHILD_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_t2_differs_from_jax_mesh_step_no_more_than_t1(arch, case, jax_mesh, capsys):
    comp, kind, value, impl = CASES[case]
    model = Model(get_config(arch, smoke=True))
    n = len(tree_leaves(model.param_shapes()))
    p0 = [jax_mesh[f"{arch}/p0/{i}"] for i in range(n)]
    want = [jax_mesh[f"{arch}/{case}/p1/{i}"] for i in range(n)]
    cc = CompressionConfig(compressor=comp, budget=BudgetConfig(kind=kind, value=value),
                           server="majority_vote")
    batch = make_batch(model.cfg.vocab_size)
    differ, metrics = {}, {}
    for t in (1, 2):
        step = build_train_step(model, TrainStepConfig(
            compression=cc, lr=LrSchedule(base=LR), vote_impl=impl), make_host_mesh(4, t))
        state = init_state(tree_unflatten(model.param_shapes(),
                                          tree_leaves(params_from_numpy(p0))),
                           server=cc.server, seed=SEED)
        if t > 1:
            state = step.shard_state(state)
        state, m = step(state, batch)
        if t > 1:
            state = step.whole_state(state)
        got = [x.numpy() for x in tree_leaves(state.params)]
        differ[t] = sum(int((_bits(a) != _bits(b)).sum()) for a, b in zip(got, want))
        metrics[t] = {k: float(v) for k, v in m.items()}
    jm = {k.split("/m/")[1]: float(v) for k, v in jax_mesh.items()
          if k.startswith(f"{arch}/{case}/m/")}
    with capsys.disabled():
        print(f"\n[{arch} {case}] JAX (4, 2) mesh step against the port: T = 2 differs in "
              f"{differ[2]}, T = 1 in {differ[1]} of {sum(x.size for x in want)} coordinates; "
              f"nnz_dropped T = 1 {metrics[1].get('nnz_dropped')}, T = 2 "
              f"{metrics[2].get('nnz_dropped')}; wire bytes JAX {jm['wire_bytes_per_device']}, "
              f"T = 1 {metrics[1]['wire_bytes_per_device']}, T = 2 "
              f"{metrics[2]['wire_bytes_per_device']}")
    assert differ[2] <= differ[1]
    # and T = 1 itself lands on JAX's mesh step, so a drift of both is caught
    assert differ[1] == 0
    assert metrics[1]["wire_bytes_per_device"] == jm["wire_bytes_per_device"]
    # a Golomb slice's capacity is its whole leaf's: at the smoke size its
    # header rows dominate, so T = 2 may ship as much as T = 1
    assert metrics[2]["wire_bytes_per_device"] <= metrics[1]["wire_bytes_per_device"]
    np.testing.assert_allclose(metrics[2]["loss"], jm["loss"], rtol=1e-5)
    if "nnz_dropped" in metrics[1]:
        assert metrics[1]["nnz_dropped"] == 0.0 and metrics[2]["nnz_dropped"] == 0.0
