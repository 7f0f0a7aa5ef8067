"""The port's streamed (FSDP) trainer against JAX's streamed step itself,
``repro.train.step_streamed.build_streamed_train_step``, on the CPU at the
smoke sizes:

(a) at M = 1 in this process, on a (1, 1) mesh, to
    ``test_torch_train.py::test_m1_matches_jax_build_train_step``'s standard;
(b) at M = 4 on a (4, 1) mesh of 4 forced host devices, run once in a
    subprocess (this file run as a script): the loss to ``LOSS_RTOL``, the
    ledger metrics exactly, the coordinates that moved to
    ``M4_MAX_MOVED_DIFFER``.

JAX's streamed step fails on this JAX version at
``repro/models/common.py:72``: inside ``axis_rules(ACT_RULES_TRAIN, mesh)``
(``repro/train/step_streamed.py:503``) a ``with_sharding_constraint`` names a
manual axis. The constraint is a placement hint and changes no number, so
this file replaces the name ``repro.train.step_streamed.axis_rules`` with a
context that does nothing, in this process and in the subprocess only; no
file of the JAX package changes.
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
# seconds: a guard on the M = 4 JAX subprocess, which takes about 30 s alone
# (JAX's two compilations) and more beside other test workers
CHILD_TIMEOUT = 240
MAX_FLIPS_M1 = 4     # coordinates whose vote may flip at M = 1 (test_torch_train's bound)
LOSS_RTOL = 1e-6     # the loss against JAX's, float32 in either order of sums
# coordinates of the M = 4 runs whose moved / unmoved state may differ from
# JAX's after two steps: each worker's gradient rounds otherwise (XLA against
# torch), so a sparsign draw may land between them; MAX_FLIPS_M1 a worker
# (measured: 0 of 119,616 and 0 of 90,688)
M4_MAX_MOVED_DIFFER = 16
M4_CASES = [("llama4-scout-17b-a16e", "allgather_packed", "majority_vote"),
            ("qwen2-vl-72b", "psum", "scaled_sign_ef")]


def _jax_runs(out_path: str) -> None:
    """The subprocess of (b): JAX's streamed step at M = 4, two steps a case,
    from ``PRNGKey(0)``'s parameters; writes the initial and final
    parameters and the metrics."""
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

    mesh = compat.make_mesh((4, 1), ("data", "model"))
    res = {}
    for c, (arch, impl, server) in enumerate(M4_CASES):
        cfg = jget(arch, smoke=True)
        model = JModel(cfg)
        params = model.init(jax.random.PRNGKey(0))
        comp = JConfig(compressor="sparsign", budget=JBudget(value=2.0), server=server)
        step = jss.build_streamed_train_step(model, jss.StreamedStepConfig(
            compression=comp, lr=JLr(base=0.05), worker_axes=("data",), vote_impl=impl,
            donate=False), mesh)
        sh = jss.fsdp_param_shardings(model, mesh)
        state = jinit(jax.tree_util.tree_map(jax.device_put, params, sh), server=server,
                      seed=7)
        if state.ef_residual is not None:   # the residual placed like the parameters
            state.ef_residual = jax.tree_util.tree_map(
                lambda p, s: jax.device_put(jnp.zeros(p.shape, jnp.float32), s), params, sh)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
            res[f"{c}/p0/{i}"] = np.asarray(leaf)
        for r in range(2):
            with compat.set_mesh(mesh):
                state, m = step(state, {k: jnp.asarray(v) for k, v in _batch(cfg, r).items()})
            for k, v in m.items():
                res[f"{c}/m{r}/{k}"] = np.asarray(v)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(state.params)):
            res[f"{c}/p2/{i}"] = np.asarray(leaf)
    np.savez(out_path, **res)


if __name__ == "__main__":   # the subprocess of (b)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    _jax_runs(sys.argv[1])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget  # noqa: E402
from repro.core.algorithm import CompressionConfig as JConfig  # noqa: E402
from repro.core.budgets import BudgetConfig as JBudget  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.algorithm import CompressionConfig  # noqa: E402
from repro_torch.core.budgets import BudgetConfig  # noqa: E402
from repro_torch.core.compressors import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.train import step_streamed as tss  # noqa: E402
from repro_torch.train.state import LrSchedule, init_state  # noqa: E402

ARCH = "llama4-scout-17b-a16e"


# ------------------------------------------------------------- (a) M = 1

@pytest.mark.parametrize("arch,server", [(ARCH, "majority_vote"),
                                         ("qwen2-vl-72b", "scaled_sign_ef")])
def test_m1_matches_jax_streamed_step(arch, server, capsys, monkeypatch):
    from jax.sharding import NamedSharding, PartitionSpec

    from repro.dist import compat as jcompat
    from repro.launch.mesh import make_host_mesh as j_host_mesh
    from repro.train.state import LrSchedule as JLr
    from repro.train.state import init_state as j_init_state

    import repro.train.step_streamed as jss
    monkeypatch.setattr(jss, "axis_rules", lambda rules, mesh=None: contextlib.nullcontext())
    jm, tm = JModel(jget(arch, smoke=True)), Model(get_config(arch, smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    impl = "allgather_packed" if server == "majority_vote" else "psum"
    mesh = j_host_mesh(1, 1)
    jstep = jss.build_streamed_train_step(jm, jss.StreamedStepConfig(
        compression=JConfig(compressor="sparsign", budget=JBudget(value=2.0), server=server),
        lr=JLr(base=0.05), worker_axes=("data",), vote_impl=impl, donate=False), mesh)
    tstep = tss.build_streamed_train_step(tm, tss.StreamedStepConfig(
        compression=CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                                      server=server),
        lr=LrSchedule(base=0.05), vote_impl=impl), make_host_mesh(1))
    jstate = jax.device_put(j_init_state(jp, server=server, seed=7),
                            NamedSharding(mesh, PartitionSpec()))
    tstate = init_state(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)),
                        server=server, seed=7)
    p0 = [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)]
    for step in range(2):
        batch = _batch(tm.cfg, step, b=2)
        with jcompat.set_mesh(mesh):
            jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tmet = tstep(tstate, batch)
        for k in ("wire_bytes_per_device", "participated", "gather_hbm_bytes", "lr"):
            assert float(tmet[k]) == float(jmet[k]), (step, k)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
        # XLA divides by the constant coordinate count through its reciprocal
        # (ROADMAP.md §3): one ulp apart at some counts
        np.testing.assert_allclose(float(tmet["nnz_frac"]), float(jmet["nnz_frac"]),
                                   rtol=2.0**-23)
        jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate.params)]
        tl = [t.numpy() for t in tree_leaves(tstate.params)]
        differ = sum(int((_bits(a) != _bits(b)).sum()) for a, b in zip(jl, tl))
        with capsys.disabled():
            print(f"\n[{arch} streamed M = 1, {server}] step {step}: {differ} of "
                  f"{sum(a.size for a in jl)} coordinates differ from JAX")
        if server == "majority_vote":
            assert differ <= MAX_FLIPS_M1
        else:   # the L1 scale's order of sums, and XLA's fused multiply-add
            for a, b, p in zip(jl, tl, p0):
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9)
                np.testing.assert_array_equal(b != p, a != p)


# ------------------------------------------------------------- (b) M = 4

@pytest.fixture(scope="module")
def jax_m4(tmp_path_factory):
    out = tmp_path_factory.mktemp("streamed") / "jax_m4.npz"
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(out.parent)), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env, capture_output=True,
                          text=True, timeout=CHILD_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("case", range(len(M4_CASES)))
def test_m4_matches_jax_streamed_step(case, jax_m4, capsys):
    arch, impl, server = M4_CASES[case]
    tm = Model(get_config(arch, smoke=True))
    n = len(tree_leaves(tm.param_shapes()))
    params = tree_leaves(params_from_numpy(
        [jax_m4[f"{case}/p0/{i}"] for i in range(n)]))
    step = tss.build_streamed_train_step(tm, tss.StreamedStepConfig(
        compression=CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                                      server=server),
        lr=LrSchedule(base=0.05), vote_impl=impl), make_host_mesh(4))
    state = init_state(tree_unflatten(tm.param_shapes(), params), server=server, seed=7)
    for r in range(2):
        state, m = step(state, _batch(tm.cfg, r))
        for k in ("wire_bytes_per_device", "gather_hbm_bytes", "participated", "lr"):
            assert float(m[k]) == float(jax_m4[f"{case}/m{r}/{k}"]), (r, k)
        np.testing.assert_allclose(float(m["loss"]), float(jax_m4[f"{case}/m{r}/loss"]),
                                   rtol=LOSS_RTOL)
    moved_differ = 0
    for i, t in enumerate(tree_leaves(state.params)):
        p0, want = jax_m4[f"{case}/p0/{i}"], jax_m4[f"{case}/p2/{i}"]
        got = t.numpy()
        moved_differ += int(((got != p0) != (want != p0)).sum())
        if server == "scaled_sign_ef":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    with capsys.disabled():
        print(f"\n[{arch} streamed M = 4 vs JAX, {impl}/{server}] {moved_differ} coordinates "
              f"moved on one side only")
    assert moved_differ <= M4_MAX_MOVED_DIFFER
