"""The port's trainer across processes, on the CPU: two gloo processes
holding 2 workers each are bit for bit one process holding all 4, for the
psum, hier (2 x 2: a pod per process) and packed gather wires, each with
and without the weighted (elastic) exchange, and for the bucketed ring
gather (32-row chunks, one hop a chunk between the processes) on the 2-bit
and golomb wires. At the wire level, pack8's ring on rank r sums in the
order of its first worker 2r: 2r, 2r - 1, ... (mod 4), as JAX's device 2r
does. Each process gets its own time limit; the processes reach each other
over ``tcp://localhost`` on a free port."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROC_TIMEOUT = 120   # seconds, per process

CHILD = r"""
import sys
import torch
import torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import tree_leaves
from repro_torch.data.synthetic import LMStreamConfig, lm_batch
from repro_torch.dist import collectives
from repro_torch.dist.collectives import ParticipationSpec
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models.model import Model
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step

def run(impl, elastic, compressor="sparsign", budget=BudgetConfig(value=2.0), **kw):
    model = Model(get_config("qwen1.5-4b", smoke=True))
    part = ParticipationSpec(weights=(1.5, 0.5, 2.0, 1.0), dropout=0.25) if elastic else None
    comp = CompressionConfig(compressor=compressor, budget=budget, server="majority_vote")
    group = make_mesh((2, 2), ("pod", "data")) if impl == "hier" else make_host_mesh(4)
    step = build_train_step(model, TrainStepConfig(
        compression=comp, lr=LrSchedule(base=0.05), vote_impl=impl,
        participation=part, **kw), group)
    state = init_state(model.init(0, device="cpu"), server=comp.server, seed=3)
    for r in range(2):
        batch = lm_batch(LMStreamConfig(vocab_size=256, seq_len=16, global_batch=4, seed=5), r)
        state, metrics = step(state, batch)
    return {"params": [t.clone() for t in tree_leaves(state.params)],
            "metrics": {k: float(v) for k, v in metrics.items()}}

def pack8_ring():
    # this process's workers' pack8 messages (all four drawn from one seed)
    # through the ring wire: the inputs and the decoded sum
    group = make_host_mesh(4)
    gen = torch.Generator().manual_seed(9)
    levels = torch.randint(-127, 128, (4, 96, 512), generator=gen, dtype=torch.int8)
    scales = torch.rand(4, generator=gen) * 1e-3
    wire = collectives.make_vote_wire("allgather_packed", group, wire_format="pack8",
                                      ring_chunk_rows=32)
    mine = slice(group.rank * group.local, (group.rank + 1) * group.local)
    n = 96 * 512 - 7
    got = wire.exchange(levels[mine], n, (n,), scale=scales[mine])
    return {"levels": levels, "scales": scales, "sum": got}

if __name__ == "__main__":
    rank, world, port, out = sys.argv[1:]
    if int(world) > 1:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=int(rank), world_size=int(world))
    try:
        res = {f"{impl}-{int(el)}": run(impl, el)
               for impl in ("psum", "hier", "allgather_packed") for el in (False, True)}
        ring = dict(bucketed=True, ring_chunk_rows=32)
        res["bucket-ring-pack2"] = run("allgather_packed", False, **ring)
        res["bucket-ring-golomb"] = run(
            "allgather_packed", False, compressor="sparsign_golomb",
            budget=BudgetConfig(kind="target_sparsity", value=0.05), **ring)
        res["pack8-ring"] = pack8_ring()
        torch.save(res, out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(world: int, tmp: pathlib.Path):
    script = tmp / "child.py"
    script.write_text(CHILD)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(tmp)), "OMP_NUM_THREADS": "1"}
    port = _free_port()
    return [subprocess.Popen([sys.executable, str(script), str(r), str(world), str(port),
                              str(tmp / f"w{world}r{r}.pt")],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case in one process of 4 workers and in two processes of 2, the
    three processes at once."""
    tmp = tmp_path_factory.mktemp("dist")
    procs = []
    try:
        for world in (1, 2):
            procs += _start(world, tmp)
        for p in procs:
            out, _ = p.communicate(timeout=PROC_TIMEOUT)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    one = torch.load(tmp / "w1r0.pt")
    return one, [torch.load(tmp / f"w2r{r}.pt") for r in range(2)]


def _same_everywhere(runs, key):
    one, two = runs[0][key], [r[key] for r in runs[1]]
    for res in two:
        for a, b in zip(res["params"], one["params"]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))
        assert res["metrics"] == one["metrics"]


@pytest.mark.parametrize("impl", ["psum", "hier", "allgather_packed"])
@pytest.mark.parametrize("elastic", [False, True])
def test_two_processes_of_two_workers_equal_one_of_four(impl, elastic, runs):
    _same_everywhere(runs, f"{impl}-{int(elastic)}")


@pytest.mark.parametrize("wire", ["pack2", "golomb"])
def test_bucketed_ring_two_processes_equal_one_of_four(wire, runs):
    """Each bucket's 32-row chunks hop between the two processes; integer
    sums, so every rank's parameters equal one process's bit for bit."""
    _same_everywhere(runs, f"bucket-ring-{wire}")


def test_pack8_ring_sums_in_the_order_of_each_process_first_worker(runs):
    """Rank r of two processes x 2 workers, and the one process of 4 (r = 0),
    equal the host sum of each worker's decoded message from +0.0, added in
    the order 2r, 2r - 1, 2r - 2, 2r - 3 (mod 4), bit for bit."""
    for world, results in ((1, [runs[0]]), (2, runs[1])):
        for rank, res in enumerate(results):
            r = res["pack8-ring"]
            n = r["sum"].numel()
            w0 = rank * (4 // world)
            acc = None
            for m in [(w0 - k) % 4 for k in range(4)]:
                d = torch.zeros(n) + r["levels"][m].reshape(-1)[:n].to(torch.float32) * r["scales"][m]
                acc = d if acc is None else acc + d
            assert torch.equal(r["sum"].view(torch.int32), acc.view(torch.int32)), (world, rank)
