"""The bucketed uplink and the ring gather under the tensor-parallel 'model'
axis, and a 'model' axis over a process subgroup, on the CPU at
``make_host_mesh(4, 2)`` in one process:

(a) the slice plan slot for slot: JAX's greedy packing
    (``repro.dist.bucketing.build_bucket_plan``) over a device's leaves (a
    cut leaf's slice, a replicated leaf whole), a Golomb slot at its whole
    leaf's capacity rows; the step's ``wire_bytes_per_device`` reckoned
    from the slots (payload rows and their padding, each bucket's side
    scalars once) and its ``gather_hbm_bytes``;
(b) two rounds of injected gradients, one bucket and capped buckets, on
    psum, hier, the 2-bit, Golomb and pack8 gathers and the decoded psum,
    elastic and not, TernGrad's shared L-inf and ``scaled_sign_ef``: the
    bucketed T = 2 step, the per-leaf T = 2 step and the bucketed T = 1 step
    give the same parameters, EF residuals and metrics bit for bit (the
    injected loss is a rank's partial at T = 2: equal among the T = 2 runs;
    ``scaled_sign_ef``'s L1 is a float sum of the slices' partials, held to
    T = 1 to rtol 1e-6), each one's wire bytes its own ledger;
(c) the ring at T = 2, per leaf and bucketed, against the monolithic T = 2
    gather and the ring at T = 1: bit for bit on the 2-bit and Golomb
    wires; pack8 bit for bit against T = 1's ring and against the
    monolithic gather within float noise (the ring adds in ring order,
    ``tests/test_torch_ring.py``);
(d) the launcher's ``--host-model 2 --bucketed [--bucket-bytes]`` and
    ``--ring``;
(e) a 'model' axis over a subgroup: four gloo processes, two subgroups of
    two building their meshes at once (one model rank a process, so the
    worker and model groups are made over the subgroup's global ranks; and
    whole workers a process), each equal bit for bit to the same step over
    a world of two processes, all within a time limit.
"""

import math
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

from repro.dist import bucketing as jbuck
from repro_torch.analysis.drivers import tp_slice_ledger
from repro_torch.core import engine
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.dist import bucketing, collectives
from repro_torch.kernels.golomb.ref import golomb_rows
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import ShapeDtype, params_from_numpy
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step

from test_torch_tp import (ELASTIC, HIER_MESH, MESH, TP_LOGICAL, TP_SHAPES, InjectedTPModel, M,
                           _tp_injected, f32bits, float_flips)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CAP = 2048            # bytes a capped bucket's payload (several buckets a plan)
RING_ROWS = 32        # ring chunk rows: one sublane tile
GOLOMB_P = 0.1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _comp(name, budget, server):
    return CompressionConfig(compressor=name, budget=BudgetConfig(value=budget), server=server)


def _mesh(impl, t):
    if t > 1:
        return HIER_MESH if impl == "hier" else MESH
    return ((2, 2), ("pod", "data")) if impl == "hier" else ((M,), ("data",))


def _run(model, tc, impl, t, params, batches, **kw):
    """Rounds of ``model`` at (4, t) from one state: (step, whole parameter
    leaves, whole EF leaves, metrics of each round)."""
    step = build_train_step(model, TrainStepConfig(
        compression=tc, lr=LrSchedule(base=0.05), vote_impl=impl, **kw), make_mesh(*_mesh(impl, t)))
    state = init_state(params_from_numpy(tree_unflatten(model.param_shapes(), list(params))),
                       server=tc.server, seed=11)
    if t > 1:
        state = step.shard_state(state)
    mets = []
    for batch in batches:
        state, m = step(state, batch)
        mets.append({k: float(v) for k, v in m.items()})
    whole = step.whole_state(state) if t > 1 else state
    efs = ([x.numpy().copy() for x in tree_leaves(whole.ef_residual)]
           if whole.ef_residual is not None else [])
    return step, [x.numpy().copy() for x in tree_leaves(whole.params)], efs, mets


def _ledger(step, model, tc) -> float:
    """The step's own ledger: a slice plan's or the per-leaf slices' at
    T = 2 (``tp_slice_ledger``), the plan's or the leaves' at T = 1."""
    if step.wire.group.model_size > 1:
        return tp_slice_ledger(step, model)
    share = engine.needs_shared_linf(tc)
    if step.plan is not None:
        return sum(bucketing.plan_ledger(step.mode, step.wire, step.plan, share_linf=share))
    return sum(collectives.uplink_ledger(step.mode, step.wire, math.prod(sd.shape),
                                         share_linf=share)
               for sd in tree_leaves(model.param_shapes()))


def _equal_bits(a, b, what):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(f32bits(x), f32bits(y), err_msg=what)


# ------------------------------------------------------- (a) the slice plan

#: format -> (compression, vote_impl, step options)
PLAN_FORMATS = {
    "int8": (_comp("sparsign", 2.0, "majority_vote"), "psum", {}),
    "pack2": (_comp("sparsign", 2.0, "majority_vote"), "allgather_packed", {}),
    "golomb": (_comp("sparsign_golomb", 0.2, "majority_vote"), "allgather_packed",
               {"golomb_p": GOLOMB_P}),
    "pack8": (_comp("qsgd8", 1.0, "mean"), "allgather_packed", {}),
    "f32": (_comp("qsgd8", 1.0, "mean"), "psum", {}),
}


def _device_shapes(step):
    """(a device's leaf shapes, the whole leaves' sizes) in flat leaf order."""
    out, sizes = [], []
    for sd, pl in zip(tree_leaves(TP_SHAPES), tree_leaves(step.placements)):
        shape = tuple(sd.shape)
        sizes.append(math.prod(shape))
        if pl.sharded:
            shape = tuple(d // pl.parts if k == pl.dim else d for k, d in enumerate(shape))
        out.append(shape)
    return out, sizes


def _slot_ledger(fmt, plan, m):
    """Per-device bytes of one application of the plan, from its slots: each
    bucket's payload rows (padding included) over M - 1 peers (the gathers)
    or a ring all-reduce (the psums: int8 sums at M = 4, float32 decoded),
    and pack8's slot scales once a bucket (one float32 a slot)."""
    total = 0.0
    for b in plan.buckets:
        if fmt == "int8":
            total += 2.0 * (m - 1) / m * b.rows * 512
        elif fmt == "f32":
            total += 2.0 * (m - 1) / m * 4 * b.rows * 512
        else:
            total += (m - 1) * b.rows * bucketing.ROW_BYTES[fmt]
        if fmt == "pack8":
            total += (m - 1) * 4 * len(b.slots)
    return total


@pytest.mark.parametrize("cap", [None, CAP])
@pytest.mark.parametrize("fmt", list(PLAN_FORMATS))
def test_slice_plan_slot_for_slot(fmt, cap):
    tc, impl, kw = PLAN_FORMATS[fmt]
    params, _, batch = _tp_injected(0, exact=True)
    step, _, _, mets = _run(InjectedTPModel(), tc, impl, 2, params, [batch], bucketed=True,
                            bucket_bytes=cap, **kw)
    plan = step.plan
    assert plan.fmt == fmt
    shapes, sizes = _device_shapes(step)
    rows = None
    if fmt == "golomb":
        rows = [golomb_rows(math.prod(s), GOLOMB_P, n) for s, n in zip(shapes, sizes)]
        for s, n, r in zip(shapes, sizes, rows):
            # a slice's capacity is its whole leaf's: above its own size's
            assert r >= golomb_rows(math.prod(s), GOLOMB_P)
        assert any(r > golomb_rows(math.prod(s), GOLOMB_P) for s, r in zip(shapes, rows))
    it = iter(rows or [])
    jplan = jbuck.build_bucket_plan([jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes], fmt,
                                    bucket_bytes=cap,
                                    rows_fn=(lambda n: next(it)) if rows else None)
    got = [(tuple((s.index, s.size, s.shape, s.row_start, s.rows) for s in b.slots), b.rows)
           for b in plan.buckets]
    want = [(tuple((s.index, s.size, tuple(s.shape), s.row_start, s.rows) for s in b.slots),
             b.rows) for b in jplan.buckets]
    assert got == want
    if cap is not None:
        assert len(plan.buckets) > 1
    ledger = _slot_ledger(fmt, plan, M)
    assert mets[0]["wire_bytes_per_device"] == np.float32(ledger)
    assert mets[0]["wire_bytes_per_device"] == np.float32(tp_slice_ledger(step, InjectedTPModel()))
    hbm = 0.0 if fmt in ("int8", "f32") else float(
        M * max(b.rows for b in plan.buckets) * bucketing.ROW_BYTES[fmt])
    assert mets[0]["gather_hbm_bytes"] == hbm


# ------------------------------------------- (b) bucketed == per leaf == T = 1

#: name: (compression, vote_impl, elastic, exact gradients, step options)
STEP_CASES = {
    "psum": (_comp("sparsign", 2.0, "majority_vote"), "psum", False, False, {}),
    "hier": (_comp("sparsign", 2.0, "majority_vote"), "hier", False, False, {}),
    "pack2": (_comp("sparsign", 2.0, "majority_vote"), "allgather_packed", False, False, {}),
    "golomb": (_comp("sparsign_golomb", 0.2, "majority_vote"), "allgather_packed", False, False,
               {"golomb_p": GOLOMB_P}),
    "pack8": (_comp("qsgd8", 1.0, "mean"), "allgather_packed", False, True, {}),
    "decoded": (_comp("qsgd8", 1.0, "mean"), "psum", False, True, {}),
    "terngrad": (_comp("terngrad", 1.0, "mean"), "allgather_packed", False, False, {}),
    "scaled_sign_ef": (_comp("sparsign", 2.0, "scaled_sign_ef"), "allgather_packed", False,
                       False, {}),
    "elastic-psum": (_comp("sparsign", 2.0, "majority_vote"), "psum", True, False, {}),
    "elastic-hier": (_comp("sparsign", 2.0, "majority_vote"), "hier", True, False, {}),
    "elastic-pack2": (_comp("sparsign", 2.0, "majority_vote"), "allgather_packed", True, False,
                      {}),
    "elastic-golomb": (_comp("sparsign_golomb", 0.2, "majority_vote"), "allgather_packed",
                       True, False, {"golomb_p": GOLOMB_P}),
    "elastic-pack8": (_comp("qsgd8", 1.0, "mean"), "allgather_packed", True, True, {}),
    "elastic-decoded": (_comp("qsgd8", 1.0, "mean"), "psum", True, True, {}),
}
COMPARED = ("nnz_frac", "participated", "nnz_dropped", "lr")


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_bucketed_t2_equals_per_leaf_t2_and_bucketed_t1(case):
    tc, impl, elastic, exact, kw = STEP_CASES[case]
    if elastic:
        kw = dict(kw, participation=ELASTIC)
    params, _, _ = _tp_injected(0, exact)
    batches = [_tp_injected(1, exact)[2], _tp_injected(2, exact)[2]]
    model = InjectedTPModel()
    runs = {}
    for label, t, opts in (("per-leaf T=2", 2, {}), ("bucketed T=2", 2, {"bucketed": True}),
                           ("capped T=2", 2, {"bucketed": True, "bucket_bytes": CAP}),
                           ("bucketed T=1", 1, {"bucketed": True}),
                           ("capped T=1", 1, {"bucketed": True, "bucket_bytes": CAP})):
        step, leaves, efs, mets = _run(model, tc, impl, t, params, batches, **kw, **opts)
        if opts.get("bucket_bytes"):
            assert len(step.plan.buckets) > 1, label
        # each run's wire bytes are its own ledger
        assert all(m["wire_bytes_per_device"] == np.float32(_ledger(step, model, tc))
                   for m in mets), label
        runs[label] = (leaves, efs, mets)
    ref_leaves, ref_efs, ref_mets = runs["per-leaf T=2"]
    assert any((a != p).any() for a, p in zip(ref_leaves, params)), "the rounds must move"
    for label, (leaves, efs, mets) in runs.items():
        if label.endswith("T=1") and tc.server == "scaled_sign_ef":
            # the whole leaf's L1 is a float sum: T = 2 adds its slices'
            # partials in rank order
            for x, y, p in zip(leaves + efs, ref_leaves + ref_efs, params + params):
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=0, err_msg=label)
            for x, y, p in zip(leaves, ref_leaves, params):
                np.testing.assert_array_equal(x != p, y != p, err_msg=label)
        else:
            _equal_bits(leaves + efs, ref_leaves + ref_efs, label)
        for m, r in zip(mets, ref_mets):
            assert {k: m.get(k) for k in COMPARED} == {k: r.get(k) for k in COMPARED}, label
            if label.endswith("T=2"):   # the injected loss: a rank's partial at T = 2
                assert m["loss"] == r["loss"], label
    # the T = 1 runs' losses agree with each other
    assert [m["loss"] for m in runs["bucketed T=1"][2]] == [m["loss"]
                                                            for m in runs["capped T=1"][2]]
    bucketed = runs["bucketed T=2"][2][0]["wire_bytes_per_device"]
    per_leaf = ref_mets[0]["wire_bytes_per_device"]
    print(f"{case}: wire bytes a device bucketed T = 2 {bucketed}, per leaf T = 2 {per_leaf}, "
          f"bucketed T = 1 {runs['bucketed T=1'][2][0]['wire_bytes_per_device']}")


# --------------------------------------------------------------- (c) the ring

#: TP_SHAPES widened so a slice spans several 32-row chunks of the 2-bit and
#: pack8 wires (w_up's slice: 30,720 coordinates, 60 rows of 512)
RING_SHAPES = {"blocks": ({"b1": ShapeDtype((2, 33), torch.float32),
                           "ln1": ShapeDtype((2, 40), torch.float32),
                           "w_up": ShapeDtype((2, 40, 768), torch.float32),
                           "wo": ShapeDtype((2, 512, 40), torch.float32)},),
               "embed": ShapeDtype((512, 40), torch.float32),
               "final_norm": ShapeDtype((40,), torch.float32),
               "lm_head": ShapeDtype((40, 512), torch.float32)}


class RingModel(InjectedTPModel):
    def param_shapes(self):
        return RING_SHAPES

    def param_logical_axes(self):
        return TP_LOGICAL


def _ring_injected(seed, exact):
    rng = np.random.RandomState(seed)
    shapes = [s.shape for s in tree_leaves(RING_SHAPES)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    per = [(rng.randint(-16, 17, (M,) + s).astype(np.float32) / 8) if exact
           else rng.randn(M, *s).astype(np.float32) * 0.3 for s in shapes]
    return params, {f"g{i}": g for i, g in enumerate(per)}


#: wire: (compression, exact gradients, step options)
RING_CASES = {
    "pack2": (_comp("sparsign", 2.0, "majority_vote"), False, {}),
    "golomb": (_comp("sparsign_golomb", 0.2, "majority_vote"), False, {"golomb_p": GOLOMB_P}),
    "elastic-golomb": (_comp("sparsign_golomb", 0.2, "majority_vote"), False,
                       {"golomb_p": GOLOMB_P, "participation": ELASTIC}),
    "pack8": (_comp("qsgd8", 1.0, "mean"), True, {}),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_at_t2_equals_the_monolithic_gather_and_t1(case):
    tc, exact, kw = RING_CASES[case]
    model = RingModel()
    params, b1 = _ring_injected(0, exact)
    _, b2 = _ring_injected(1, exact)
    ring = {"ring_chunk_rows": RING_ROWS}
    runs = {}
    for label, t, opts in (("monolithic T=2", 2, {}), ("ring T=2", 2, ring),
                           ("bucketed ring T=2", 2, dict(ring, bucketed=True)),
                           ("ring T=1", 1, ring),
                           ("bucketed ring T=1", 1, dict(ring, bucketed=True))):
        step, leaves, _, mets = _run(model, tc, "allgather_packed", t, params, [b1, b2],
                                     **kw, **opts)
        assert all(m["wire_bytes_per_device"] == np.float32(_ledger(step, model, tc))
                   for m in mets), label
        assert all(m.get("nnz_dropped", 0.0) == 0.0 for m in mets), label
        runs[label] = (leaves, mets, step)
    mono, mono_mets, _ = runs["monolithic T=2"]
    assert any((a != p).any() for a, p in zip(mono, params)), "the rounds must move"
    # w_up's slice spans several chunks (a Golomb message is one chunk)
    wire = runs["ring T=2"][2].wire
    assert wire.ring_chunk_rows == RING_ROWS
    assert case.endswith("golomb") or wire.ring_chunks(30720) > 1
    for label in ("ring T=2", "bucketed ring T=2"):
        leaves, mets, _ = runs[label]
        assert mets[-1]["gather_hbm_bytes"] < mono_mets[-1]["gather_hbm_bytes"], label
        if case == "pack8":
            # ring order (0, 3, 2, 1) against worker order: rounding only
            flips = float_flips(leaves, mono, params)
            bits = sum(int((f32bits(x) != f32bits(y)).sum()) for x, y in zip(leaves, mono))
            print(f"pack8 {label} against the monolithic gather: {bits} coordinates differ in "
                  f"any bit, {flips} beyond float noise")
            assert flips == 0, label
        else:
            _equal_bits(leaves, mono, label)
        _equal_bits(leaves, runs[label.replace("T=2", "T=1")][0], label)
        # the loss reads the parameters: pack8's second round starts apart
        keys = COMPARED + (() if case == "pack8" else ("loss",))
        for m, r in zip(mets, mono_mets):
            assert {k: m.get(k) for k in keys} == {k: r.get(k) for k in keys}, label


# ------------------------------------------------------------ (d) the launcher

@pytest.mark.parametrize("flags", [["--bucketed"], ["--bucketed", "--bucket-bytes", "2048"],
                                   ["--ring", "--ring-chunk-rows", "32"],
                                   ["--bucketed", "--ring", "--ring-chunk-rows", "32"]])
def test_launcher_host_model_2_bucketed_and_ring(flags):
    """``--host-model 2`` with the bucketed uplink (one bucket or capped) and
    the ring (per leaf or bucketed) trains, its wire bytes the slice ledger,
    its parameters those of the per-leaf monolithic run."""
    from repro_torch.launch import train as tlaunch
    base = ["--arch", "qwen1.5-4b", "--device", "cpu", "--host-data", "2", "--host-model", "2",
            "--batch", "4", "--seq-len", "16", "--steps", "2", "--vote-impl",
            "allgather_packed", "--server", "majority_vote", "--compressor", "sparsign_golomb",
            "--budget-kind", "target_sparsity", "--budget", "0.05"]
    runs = {}
    for label, extra in (("per leaf", []), ("flags", flags)):
        args = tlaunch.parser().parse_args(base + extra)
        cfg, model, group, step, state, _ = tlaunch.build_everything(args)
        fn = tlaunch.batch_fn_for(cfg, args)
        for k in range(args.steps):
            state, m = step(state, fn(k))
            assert float(m["wire_bytes_per_device"]) == np.float32(tp_slice_ledger(step, model))
            assert float(m["nnz_dropped"]) == 0.0
        runs[label] = [x.clone() for x in tree_leaves(step.whole_state(state).params)]
    assert ("--bucketed" in flags) == (step.plan is not None)
    if "--bucket-bytes" in flags:
        assert len(step.plan.buckets) > 1
    for a, b in zip(runs["flags"], runs["per leaf"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ------------------------------------------------------- (e) process subgroups

CHILD = r"""
import datetime
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

def run(group, data, impl, budget, compressor="sparsign", **kw):
    model = Model(get_config("qwen1.5-4b", smoke=True))
    comp = CompressionConfig(compressor=compressor, budget=budget, server="majority_vote")
    step = build_train_step(model, TrainStepConfig(
        compression=comp, lr=LrSchedule(base=0.05), vote_impl=impl, **kw),
        make_mesh((data, 2), ("data", "model"), group=group))
    state = step.shard_state(init_state(model.init(0, device="cpu"), server=comp.server, seed=3))
    for r in range(2):
        batch = lm_batch(LMStreamConfig(vocab_size=256, seq_len=16, global_batch=4, seed=5), r)
        state, metrics = step(state, batch)
    whole = step.whole_state(state)
    return {"params": [t.clone() for t in tree_leaves(whole.params)],
            "metrics": {k: float(v) for k, v in metrics.items()}}

if __name__ == "__main__":
    rank, world, port, out = sys.argv[1:]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        group = None
        if world == 4:   # two subgroups, {0, 2} and {1, 3}: every process makes both
            subs = [dist.new_group([0, 2]), dist.new_group([1, 3])]
            group = subs[rank % 2]
        golomb = BudgetConfig(kind="target_sparsity", value=0.05)
        res = {"1x2": run(group, 1, "psum", BudgetConfig(kind="l2_norm", value=0.1)),
               "1x2-bucketed-golomb": run(group, 1, "allgather_packed", golomb,
                                          "sparsign_golomb", bucketed=True),
               "2x2-bucketed-ring-golomb": run(group, 2, "allgather_packed", golomb,
                                               "sparsign_golomb", bucketed=True,
                                               ring_chunk_rows=32)}
        torch.save(res, out)
    finally:
        dist.destroy_process_group()
"""
SUBGROUP_KEYS = ["1x2", "1x2-bucketed-golomb", "2x2-bucketed-ring-golomb"]
SUBGROUP_TIMEOUT = 150   # seconds for all six processes; each takes a few alone


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def subgroup_runs(tmp_path_factory):
    """Four processes (two subgroups of two) and two (the whole world), at
    once; every process is killed if any outlives the limit."""
    tmp = tmp_path_factory.mktemp("tp_subgroup")
    script = tmp / "child.py"
    script.write_text(CHILD)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(tmp)), "OMP_NUM_THREADS": "1"}
    procs = []
    try:
        for world in (4, 2):
            port = _free_port()
            procs += [subprocess.Popen([sys.executable, str(script), str(r), str(world),
                                        str(port), str(tmp / f"w{world}r{r}.pt")],
                                       env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                      for r in range(world)]
        for p in procs:
            out, _ = p.communicate(timeout=SUBGROUP_TIMEOUT)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return ([torch.load(tmp / f"w4r{r}.pt") for r in range(4)],
            [torch.load(tmp / f"w2r{r}.pt") for r in range(2)])


@pytest.mark.parametrize("key", SUBGROUP_KEYS)
def test_model_axis_over_a_subgroup_equals_a_world_of_two(key, subgroup_runs):
    """(1 x 2) over a subgroup of two (a model rank a process: the worker
    and model groups made over the subgroup's global ranks, 1 and 3 for the
    second), per leaf on psum and bucketed on the Golomb wire, and (2 x 2)
    whole workers a process on the Golomb wire's bucketed ring: every
    process of both subgroups ends with the parameters and metrics of the
    same step over a world of two, bit for bit."""
    four, two = subgroup_runs
    ref = two[0][key]
    for res in two[1:] + four:
        for a, b in zip(res[key]["params"], ref["params"]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert res[key]["metrics"] == ref["metrics"]
