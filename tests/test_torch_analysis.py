"""The port's analysis gate, ``repro_torch.analysis``, on the CPU: the tests
of ``tests/test_analysis.py`` that have a counterpart in the port.

The framework's exit codes and rendering; the collective recorder's byte
math (all-reduce, all-gather, the ring's hop loop) on calls of the wrappers
themselves, an unknown collective blocking, and no record outside a block;
the census equal to the VoteWire ledger for every wire mode per leaf,
bucketed and on the ring (at M = 16 in one process), with its launch-count
budgets; the elastic censuses and a dropped worker's payload recorded as
zeros; the gather-HBM and entropy-wire floors; the fused wire ops against
their plain chains; the AST lint rules, positive and negative, the repo
green with the allowlist empty; the specs complete; and
``python -m repro_torch.analysis --device cpu`` exiting 0. The gate's own
on-card check (one launch a fused op) runs in ``chip_smoke.py``. About 15 s
alone.
"""

import dataclasses

import pytest
import torch

from repro_torch.analysis import drivers
from repro_torch.analysis.framework import Finding, merge, report
from repro_torch.analysis.repolint import ALLOWLIST, SpecsComplete, lint_source, run_repolint
from repro_torch.analysis.rules import (CollectiveCensus, CollectiveCountBudget,
                                        EntropyWireBudget, FusedOneLaunch, GatherHbmBudget,
                                        MaskedPayloadZero)
from repro_torch.dist import collectives
from repro_torch.dist.collectives import Census, CollectiveRecord, WorkerGroup

M = drivers.HYPOTHETICAL_M
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: these tiny-model steps are bound by op launches,
    and 8 threads a worker only crowd the other test workers (alone: 15 s
    on one thread, 34 s on 8)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------- framework

def test_report_exit_codes_and_render():
    ok = report([], checks=3)
    assert ok.ok and ok.exit_code() == 0 and "OK: 3 checks" in ok.render()
    f = Finding(rule="r", where="w", message="m")
    bad = report([f], checks=1)
    assert not bad.ok and bad.exit_code() == 1 and "FAIL" in bad.render()
    assert "[error] r: w: m" in bad.render()
    note = Finding(rule="r", where="w", message="m", severity="info")
    advisory = report([note], checks=1)
    assert advisory.ok and advisory.exit_code() == 0
    merged = merge([ok, bad, advisory])
    assert merged.checks == 5 and len(merged.findings) == 2
    assert not merged.ok


def test_finding_rejects_unknown_severity():
    with pytest.raises(AssertionError):
        Finding(rule="r", where="w", message="m", severity="warning")


# --------------------------------------------------------- the recorder

def test_census_byte_math_on_the_wrappers():
    """The wrappers themselves, in one process of m workers: an integer
    all-reduce of a partial, a float sum gathered in worker order (billed as
    the all-reduce it stands for), a max, an all-gather of integer payloads,
    a metric scalar (not billed). The gathered float sum moves (M - 1) x in
    between processes, which ``moved_bytes`` reports beside the bill."""
    m, n = 8, 1024
    group = WorkerGroup(("data",), (m,))
    votes = torch.ones((m, n), dtype=torch.int8)
    with collectives.record_collectives() as census:
        collectives.vote_psum(votes, group, m)                        # int8 payload
        collectives.ordered_psum(torch.zeros((m, n)), group)          # f32 sum, gathered
        group.all_reduce(torch.zeros(()), op=torch.distributed.ReduceOp.MAX)   # f32 scalar
        group.gather(votes)                                           # int8 all-gather
        collectives.scalar_psum(torch.zeros(m), group)                # a metric
    assert census.counts() == {"psum": 3, "pmax": 1, "all_gather": 1}
    assert census.payload_bytes() == pytest.approx(
        2 * (m - 1) / m * n + 2 * (m - 1) / m * 4 * n + (m - 1) * n)
    assert census.scalar_bytes() == pytest.approx(2 * (m - 1) / m * 4)   # not the metric
    assert [r.role for r in census.records] == ["wire"] * 4 + ["scalar"]
    assert census.payload_count() == 3 and census.scalar_count() == 2
    assert [r.moved for r in census.records] == ["", "all_gather", "", "", "all_gather"]
    assert census.moved_bytes() == pytest.approx(
        census.payload_bytes() + census.scalar_bytes() + ((m - 1) - 2 * (m - 1) / m) * 4 * n)
    rule = CollectiveCensus()
    assert rule.check("prog", census, ledger_payload=census.payload_bytes(),
                      ledger_scalar=2 * (m - 1) / m * 4) == []
    assert len(rule.check("prog", census, ledger_payload=12345.0, ledger_scalar=1e9)) == 2
    # one worker: every ring term vanishes
    one = WorkerGroup(("data",), (1,))
    with collectives.record_collectives() as c1:
        one.gather(votes[:1])
    assert c1.payload_bytes() == 0.0 and c1.payload_count() == 1


def test_census_ring_math():
    """A ring's hop loop is one record a chunk (and one a side channel),
    billed (M - 1) x a worker's chunk, as JAX's traced ppermute is."""
    rec = CollectiveRecord(primitive="ppermute", in_elems=2048, in_bytes=2048,
                           dtype="uint8", n_workers=16)
    assert rec.ring_bytes() == pytest.approx(15 * 2048)
    assert dataclasses.replace(rec, n_workers=1).ring_bytes() == 0.0
    m, rows = 4, 64
    group = WorkerGroup(("data",), (m,))
    msgs = [torch.full((rows, 128), j, dtype=torch.uint8) for j in range(m)]
    with collectives.record_collectives() as census:
        list(collectives._ring_order(msgs, (torch.ones((m, 1)),), group))
    assert census.counts() == {"ppermute": 2}
    assert census.payload_bytes() == pytest.approx((m - 1) * rows * 128)
    assert census.scalar_bytes() == pytest.approx((m - 1) * 4)
    assert census.records[0].zero_workers == (True, False, False, False)


def test_census_unknown_collective_blocks():
    mystery = CollectiveRecord(primitive="all_to_all_v", in_elems=512, in_bytes=512,
                               dtype="int8", n_workers=16)
    census = Census()
    census.add(mystery)
    assert census.unknown == [mystery] and census.records == []
    findings = CollectiveCensus().check("prog", census, ledger_payload=0.0, ledger_scalar=0.0)
    assert any("does not cover" in f.message and "all_to_all_v" in f.message
               for f in findings)
    assert all(f.severity == "error" for f in findings)
    assert census.payload_bytes() == 0.0


def test_nothing_is_recorded_outside_a_block():
    group = WorkerGroup(("data",), (4,))
    with collectives.record_collectives() as census:
        pass
    group.gather(torch.ones((4, 8), dtype=torch.int8))
    assert census.records == [] and collectives._CENSUSES == []


# ------------------------------------------ the census against the ledger

@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("mode", list(drivers.MODE_SETUPS) + list(drivers.RING_SETUPS))
def test_step_census_matches_wire_ledger(mode, bucketed):
    findings, census, payload, scalar = drivers.census_check(mode, device=CPU,
                                                             bucketed=bucketed)
    assert findings == [], "\n".join(f.render() for f in findings)
    assert payload > 0   # non-vacuous at M = 16
    assert census.payload_bytes() == payload and census.scalar_bytes() == scalar
    # the count budget on the same run
    findings, census, expected = drivers.count_check(mode, device=CPU, bucketed=bucketed)
    assert findings == [], "\n".join(f.render() for f in findings)
    assert census.payload_count() == expected > 0


def test_count_budget_rule_and_ratio_floor():
    census = Census()
    for _ in range(3):
        census.add(CollectiveRecord("all_gather", 64, 64, "uint8", 16))
    census.add(CollectiveRecord("psum", 1, 4, "float32", 16, role="scalar"))
    rule = CollectiveCountBudget()
    assert rule.check("x", census, expected_payload=3, max_scalar=1) == []
    assert len(rule.check("x", census, expected_payload=2, max_scalar=0)) == 2
    findings, checks = drivers.count_ratio_checks()
    assert findings == [] and checks == len(drivers.RATIO_CONFIGS) * len(drivers.MODE_SETUPS)


def test_participation_gate_green_and_masked_payload_zero():
    """The elastic censuses, counts and MaskedPayloadZero over every setup;
    the rule flags a dropped worker's nonzero bytes."""
    dropped = drivers.dropped_workers(M)
    assert 0 < len(dropped) < M
    findings, checks = drivers.run_participation_checks(device=CPU)
    errors = [f for f in findings if f.severity == "error"]
    assert errors == [], "\n".join(f.render() for f in errors)
    notes = [f for f in findings if f.severity == "info"]
    assert len(notes) == 1 and "worker-order gathers" in notes[0].message
    for label in ("step[votes/elastic]", "step[scaled_votes/bucketed/elastic]",
                  "step[decoded/elastic]"):
        assert label in notes[0].message
    assert checks == 3 * 2 * len(drivers.MODE_SETUPS) + len(drivers.RING_SETUPS)
    rec = CollectiveRecord("all_gather", 128, 128, "uint8", 4, zero_workers=(True, False,
                                                                               True, True))
    census = Census()
    census.add(rec)
    rule = MaskedPayloadZero()
    assert rule.check("x", census, [0, 2]) == []
    assert len(rule.check("x", census, [1])) == 1
    assert len(rule.check("x", census, [])) == 1    # nothing dropped: nothing held
    assert rule.check("x", Census(), [1]) == []     # no integer gather (a psum wire)


# ------------------------------------------------------------- ledger floors

def test_gather_hbm_budget_math_and_green():
    rule = GatherHbmBudget(min_ratio=8.0)
    assert rule.check("x", ring_bytes=2 * 4096.0, mono_bytes=16 * 4096.0) == []
    bad = rule.check("x", ring_bytes=3 * 4096.0, mono_bytes=16 * 4096.0)
    assert len(bad) == 1 and "under the 8.0x floor" in bad[0].message
    findings, checks = drivers.gather_hbm_checks()
    assert findings == [], "\n".join(f.render() for f in findings)
    assert checks == len(drivers.RATIO_CONFIGS) * len(drivers.RING_SETUPS) * 2


def test_entropy_wire_budget_math_and_green():
    rule = EntropyWireBudget(2.0)
    assert rule.check("x", golomb_bytes=100.0, pack2_bytes=200.0) == []
    assert len(rule.check("x", golomb_bytes=101.0, pack2_bytes=200.0)) == 1
    findings, checks = drivers.entropy_wire_checks()
    assert findings == [] and checks == 2 * len(drivers.RATIO_CONFIGS)


# --------------------------------------------------------- the fused ops

def test_every_fused_spec_equals_its_plain_chain():
    findings, checks = drivers.run_spec_checks(CPU)
    assert findings == [], "\n".join(f.render() for f in findings)
    assert checks >= 2 * 6   # every ternary fused row, golomb and qsgd8, in two dtypes


def test_fused_one_launch_rule():
    rule = FusedOneLaunch(slack_bytes=1024)
    enc = "encode_kernel<"
    one = dict(wrapper_launches={"sparsign_pack2bit": 1}, encoder=enc, device_kernels=3)
    assert rule.check("x", port_kernels=["ns::encode_kernel<T>(...)"], extra_bytes=0,
                      **one) == []
    two = rule.check("x", wrapper_launches={"sparsign": 1, "pack2bit": 1},
                     port_kernels=["sparsign_kernel(...)", "pack2bit_kernel(...)"],
                     device_kernels=4, encoder=enc, extra_bytes=1 << 20)
    assert len(two) == 3
    blind = rule.check("x", port_kernels=[], extra_bytes=0,
                       **dict(one, device_kernels=0))
    assert [f.message for f in blind] == ["torch.profiler saw no device activity"]


# ---------------------------------------------------------------- repolint

def test_lint_flags_compressor_name_branching():
    src = "def f(cfg):\n    if cfg.compressor == 'sparsign':\n        return 1\n"
    hits = lint_source(src, "repro_torch/train/foo.py")
    assert [f.rule for f in hits] == ["no-compressor-name-branching"]
    src = "def f(algorithm):\n    return algorithm in ('sign', 'terngrad')\n"
    assert len(lint_source(src, "repro_torch/train/foo.py")) == 1
    src = "def f(cfg):\n    return cfg.compressor.startswith('qsgd')\n"
    assert len(lint_source(src, "repro_torch/train/foo.py")) == 1


def test_lint_name_branching_negatives():
    src = "def f(mode):\n    return mode == 'sign'\n"
    assert lint_source(src, "repro_torch/train/foo.py") == []
    src = "def f(spec):\n    return spec.wire_format == 'pack2'\n"
    assert lint_source(src, "repro_torch/train/foo.py") == []
    src = "def g(compressor):\n    return compressor == 'sparsign'\n"
    assert lint_source(src, "repro_torch/core/compressors.py") == []


@pytest.mark.parametrize("src", [
    "import torch.distributed as dist\ndef f(x):\n    dist.all_reduce(x)\n",
    "import torch\ndef f(x, o):\n    torch.distributed.all_gather_into_tensor(o, x)\n",
    "from torch import distributed as d\ndef f(ops):\n    return d.batch_isend_irecv(ops)\n",
    "import torch.distributed as dist\ndef f(x):\n    dist.broadcast(x, 0)\n",
    "from torch.distributed import isend\n",
])
def test_lint_flags_raw_collectives(src):
    hits = lint_source(src, "repro_torch/train/foo.py")
    assert [f.rule for f in hits] == ["no-raw-collectives"]
    assert lint_source(src, "repro_torch/dist/collectives.py") == []   # the home


def test_lint_allows_collectives_that_move_nothing():
    src = ("import torch.distributed as dist\n"
           "def f(g):\n"
           "    if dist.is_available() and dist.is_initialized():\n"
           "        dist.init_process_group('gloo')\n"
           "        return dist.get_rank(g), dist.get_world_size(g), dist.group.WORLD\n"
           "def h(group):\n"
           "    return group.gather(1)\n")
    assert lint_source(src, "repro_torch/launch/foo.py") == []


def test_repolint_repo_green_with_empty_allowlist():
    assert len(ALLOWLIST) == 0
    findings, checks = run_repolint()
    assert findings == [], "\n".join(f.render() for f in findings)
    assert checks > 100


def test_specs_complete_rule_green_and_flags_a_bad_row(monkeypatch):
    assert SpecsComplete().check() == []
    from repro_torch.core import compressors as C
    bad = dataclasses.replace(C.SPECS["sign"], uplink_bits="one_bit", kernel_op=None)
    monkeypatch.setitem(C.SPECS, "sign", bad)
    assert len(SpecsComplete().check()) == 2


def test_gate_exits_zero_on_the_cpu(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "OK:" in out and "collective census: 16 checks, 1 findings" in out
