"""The port's streamed (FSDP) trainer at M = 4 x T = 2 against JAX's own
streamed step, ``repro.train.step_streamed.build_streamed_train_step``, on a
(4 data, 2 model) mesh of 8 forced host devices (the mesh of
``tests/mdev/check_step_streamed.py``), run once in a subprocess (this file
run as a script): JAX's ``shard_map`` is manual over the worker and FSDP
axes and GSPMD places 'model', so its step compresses whole leaves.

Cases: llama4-scout-17b-a16e, fixed sparsign with majority vote on
allgather_packed, per leaf and bucketed; qwen2-vl-72b (``positions3``) on
psum with ``scaled_sign_ef``. Two steps from JAX's ``PRNGKey(0)``
parameters. The criterion: the port's T = 2 parameters part from JAX's in no
more coordinates than the port's T = 1 parameters do (each side's float32
gradients round otherwise, XLA against torch; both counts printed), the loss
to ``LOSS_RTOL``, JAX's ledger metrics equal to the port's T = 1 (JAX bills
the whole leaves; the port's T = 2 bills a device's slices). With
``scaled_sign_ef`` the coordinates that moved on one side only are held the
same way (the server's L1 adds its partials in another order on each side,
which may put a moved coordinate an ulp apart), and the parameters agree to
rtol 1e-5, as ``tests/test_torch_streamed_jax.py`` holds M = 4.

jamba-1.5-large-398b stays out (its (4, 2) compilation takes about a
minute): ``tests/test_torch_streamed_tp.py`` holds it against the port's
T = 1. JAX's streamed step needs its ``axis_rules`` hint replaced by a
no-op context on this JAX version (``tests/test_torch_streamed_jax.py``
says why); that is done in the subprocess only, and no JAX file changes.
"""

import contextlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from test_torch_streamed import _batch, _bits

ROOT = pathlib.Path(__file__).resolve().parents[1]
# seconds: a guard on the JAX subprocess (three compilations of the (4, 2)
# streamed step, about 15 s each alone)
CHILD_TIMEOUT = 240
LOSS_RTOL = 1e-6
# case -> (arch, vote_impl, server, bucketed)
CASES = [("llama4-scout-17b-a16e", "allgather_packed", "majority_vote", False),
         ("llama4-scout-17b-a16e", "allgather_packed", "majority_vote", True),
         ("qwen2-vl-72b", "psum", "scaled_sign_ef", False)]
STEPS = 2


def _jax_runs(out_path: str) -> None:
    """The subprocess: JAX's streamed step on the (4, 2) mesh, STEPS steps a
    case; writes the initial and final parameters and the metrics."""
    import jax
    import jax.numpy as jnp

    import repro.train.step_streamed as jss
    jss.axis_rules = lambda rules, mesh=None: contextlib.nullcontext()   # this process only
    from repro.configs.registry import get_config as jget
    from repro.core.algorithm import CompressionConfig as JConfig
    from repro.core.budgets import BudgetConfig as JBudget
    from repro.dist import compat
    from repro.models.model import Model as JModel
    from repro.train.state import LrSchedule as JLr
    from repro.train.state import init_state as jinit

    mesh = compat.make_mesh((4, 2), ("data", "model"))
    res = {}
    for c, (arch, impl, server, bucketed) in enumerate(CASES):
        cfg = jget(arch, smoke=True)
        model = JModel(cfg)
        params = model.init(jax.random.PRNGKey(0))
        comp = JConfig(compressor="sparsign", budget=JBudget(value=2.0), server=server)
        step = jss.build_streamed_train_step(model, jss.StreamedStepConfig(
            compression=comp, lr=JLr(base=0.05), worker_axes=("data",), vote_impl=impl,
            donate=False, bucketed=bucketed), mesh)
        sh = jss.fsdp_param_shardings(model, mesh)
        state = jinit(jax.tree_util.tree_map(jax.device_put, params, sh), server=server,
                      seed=7)
        if state.ef_residual is not None:   # the residual placed like the parameters
            state.ef_residual = jax.tree_util.tree_map(
                lambda p, s: jax.device_put(jnp.zeros(p.shape, jnp.float32), s), params, sh)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
            res[f"{c}/p0/{i}"] = np.asarray(leaf)
        for r in range(STEPS):
            with compat.set_mesh(mesh):
                state, m = step(state, {k: jnp.asarray(v) for k, v in _batch(cfg, r).items()})
            for k, v in m.items():
                res[f"{c}/m{r}/{k}"] = np.asarray(v)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(state.params)):
            res[f"{c}/p{STEPS}/{i}"] = np.asarray(leaf)
    np.savez(out_path, **res)


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
from repro_torch.train import step_streamed as tss  # noqa: E402
from repro_torch.train.state import LrSchedule, init_state  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_mesh_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("streamed_tp") / "jax_4x2.npz"
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(out.parent)), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env, capture_output=True,
                          text=True, timeout=CHILD_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def _port_run(case, jax_res, t):
    """The port's STEPS steps at (4, t) from JAX's first parameters: (the
    whole final leaves, each step's metrics)."""
    arch, impl, server, bucketed = CASES[case]
    model = Model(get_config(arch, smoke=True))
    n = len(tree_leaves(model.param_shapes()))
    params = tree_leaves(params_from_numpy([jax_res[f"{case}/p0/{i}"] for i in range(n)]))
    step = tss.build_streamed_train_step(model, tss.StreamedStepConfig(
        compression=CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                                      server=server),
        lr=LrSchedule(base=0.05), vote_impl=impl, bucketed=bucketed), make_host_mesh(4, t))
    state = step.shard_state(init_state(tree_unflatten(model.param_shapes(), params),
                                        server=server, seed=7))
    mets = []
    for r in range(STEPS):
        state, m = step(state, _batch(model.cfg, r))
        mets.append({k: float(v) for k, v in m.items()})
    return [x.numpy() for x in tree_leaves(step.whole_state(state).params)], mets


@pytest.mark.parametrize("case", range(len(CASES)))
def test_t2_no_farther_from_jax_than_t1(case, jax_mesh_runs, capsys):
    arch, impl, server, bucketed = CASES[case]
    res = jax_mesh_runs
    got = {t: _port_run(case, res, t) for t in (1, 2)}
    n = len(got[1][0])
    want = [res[f"{case}/p{STEPS}/{i}"] for i in range(n)]
    p0 = [res[f"{case}/p0/{i}"] for i in range(n)]
    for r in range(STEPS):
        for k in ("wire_bytes_per_device", "gather_hbm_bytes", "participated", "lr"):
            assert got[1][1][r][k] == float(res[f"{case}/m{r}/{k}"]), (r, k)
        for t in (1, 2):
            np.testing.assert_allclose(got[t][1][r]["loss"], float(res[f"{case}/m{r}/loss"]),
                                       rtol=LOSS_RTOL)
    ef = server == "scaled_sign_ef"
    differ, bits = {}, {}
    for t in (1, 2):
        bits[t] = sum(int((_bits(a) != _bits(b)).sum()) for a, b in zip(got[t][0], want))
        if ef:   # moved on one side only; the values to rtol 1e-5
            differ[t] = sum(int(((a != p) != (b != p)).sum())
                            for a, b, p in zip(got[t][0], want, p0))
            for a, b in zip(got[t][0], want):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
        else:
            differ[t] = bits[t]
    size = sum(a.size for a in want)
    with capsys.disabled():
        print(f"\n[{arch} streamed vs JAX's (4, 2) mesh, {impl}/{server}"
              f"{' bucketed' if bucketed else ''}] coordinates of {size} apart from JAX "
              f"({'moved on one side only' if ef else 'any bit'}): T = 2 {differ[2]}, "
              f"T = 1 {differ[1]}; in any bit T = 2 {bits[2]}, T = 1 {bits[1]}")
    assert differ[2] <= differ[1] and bits[2] <= bits[1]
