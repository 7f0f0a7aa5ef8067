"""chip_smoke.py must fail loudly without a card: a non-zero exit and no
``"ok": true`` line, so the port's main path can never pass on the CPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread while this module's rehearsals run: smoke-size
    phases are bound by op launches, and 8 threads a worker only crowd the
    other test workers (the zoo and ring rehearsals: 11.6 s on one thread,
    32.3 s and 144 s of CPU on 8)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(script: pathlib.Path, cwd: pathlib.Path):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "CUDA_VISIBLE_DEVICES": "",
           "HOME": os.environ.get("HOME", str(cwd))}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=60)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":  # a directory that holds chip_smoke.py and nothing else
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = _run(script, script.parent)
    assert proc.returncode != 0, proc.stdout
    assert '"ok": true' not in proc.stdout


def test_plain_versions_barred_covers_the_trainer_path():
    """chip_smoke.py bars every plain version on the trainer's path while it
    counts launches: each name it patches exists, a barred one raises, and
    leaving the block restores it."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    import torch

    from repro_torch.core import engine
    from repro_torch.core.algorithm import CompressionConfig
    from repro_torch.dist.collectives import make_vote_wire
    from repro_torch.launch.mesh import make_mesh

    wire = make_vote_wire("allgather_packed", make_mesh((1,), ("data",)))
    g = torch.ones(600)
    with chip_smoke.plain_versions_barred():
        with pytest.raises(RuntimeError, match="plain version"):
            engine.compress_leaf(g, CompressionConfig(), 1, wire=wire)
    assert engine.compress_leaf(g, CompressionConfig(), 1, wire=wire).values.shape == (32, 128)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_sass_loops_counts_each_loop_body():
    """The SASS census behind PERF.md's instructions a coordinate: a loop is
    the span from a backward branch's target to the branch."""
    listing = """
        Function : _Z6kernelPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   SHF.R.U32.HI R2, RZ, 0x10, R3 ;
        /*0020*/                   LOP3.LUT R2, R2, R3, R4, 0x96, !PT ;
        /*0030*/               @P0 IMAD R2, R2, 0x3, RZ ;
        /*0040*/              @!P1 BRA 0x10 ;
        /*0050*/                   EXIT ;
        /*0060*/                   BRA 0x60 ;
"""
    census = _chip_smoke().sass_loops(listing)
    assert census["_Z6kernelPf"]["instructions"] == 7
    loops = census["_Z6kernelPf"]["loops"]
    assert [loop["instructions"] for loop in loops] == [4]
    assert loops[0]["by_opcode"] == {"SHF": 1, "LOP3": 1, "IMAD": 1, "BRA": 1}


def test_sass_loops_straight_path_skips_the_other_body():
    """A loop that holds two bodies behind a branch on a uniform flag: the
    straight path falls through the predicated branch into the first body,
    jumps over the second with the unconditional branch, and ends at the
    backward branch."""
    listing = """
        Function : _Z6kernelPf
        /*0000*/                   MOV R1, R2 ;
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0020*/              @!P0 BRA 0x60 ;
        /*0030*/                   FFMA R3, R3, R4, R5 ;
        /*0040*/                   FFMA R3, R3, R4, R5 ;
        /*0050*/                   BRA 0x90 ;
        /*0060*/                   MUFU.RCP R6, R4 ;
        /*0070*/                   FCHK P1, R3, R4 ;
        /*0080*/                   FFMA R3, R6, R3, RZ ;
        /*0090*/                   STG.E [R8], R3 ;
        /*00a0*/               @P2 BRA 0x10 ;
        /*00b0*/                   EXIT ;
"""
    loop = _chip_smoke().sass_loops(listing)["_Z6kernelPf"]["loops"][0]
    assert loop["instructions"] == 10
    assert loop["straight"] == 7
    assert loop["straight_by_opcode"] == {"FFMA": 2, "BRA": 3, "IADD3": 1, "STG": 1}


def test_pack2_owner_tells_the_two_encoders_apart():
    """Both fused 2-bit encoders launch encode_tiles.cuh's encode_kernel; a
    trace attributes the sparsign rule to sparsign_pack2bit and the others
    to ternary_pack2bit."""
    owner = _chip_smoke().encoder_owner
    assert owner("void repro::encode_kernel<repro::Pack2Encoder<__nv_bfloat16, "
                 "repro::SparsignRule>>(const T1::In *)") == "sparsign_pack2bit"
    assert owner("void repro::encode_kernel<repro::Pack2Encoder<float, "
                 "repro::NoisySignRule>>(const T1::In *)") == "ternary_pack2bit"
    assert owner("void (anonymous namespace)::ternary_kernel<float, 4, 1>(const T1 *)") is None


@pytest.mark.parametrize("dtype", ["float", "__nv_bfloat16"])
def test_encoder_owner_tells_qsgd8_from_the_2bit_encoders(dtype):
    """qsgd8_pack8 launches the same walker with its own encoder type: its
    time is its own, not ternary_pack2bit's; unpack8_sum keeps its name."""
    owner = _chip_smoke().encoder_owner
    assert owner(f"void repro::encode_kernel<(anonymous namespace)::Qsgd8Encoder<{dtype}>>"
                 f"(const T1::In *)") == "qsgd8_pack8"
    assert owner("void (anonymous namespace)::unpack8_sum_kernel(const signed char *)") is None


def test_plain_versions_barred_covers_the_ring():
    """The ring decodes through the barred names too: a ring exchange of
    CPU messages inside the block reaches a plain version and raises, so a
    counted ring run on the card shows the kernels ran."""
    import torch

    from repro_torch.dist.collectives import make_vote_wire
    from repro_torch.launch.mesh import make_mesh

    group = make_mesh((2,), ("data",))
    msgs = torch.zeros((2, 64, 128), dtype=torch.uint8)
    for fmt in ("pack2", "pack8"):
        wire = make_vote_wire("allgather_packed", group, wire_format=fmt, ring_chunk_rows=32)
        values = msgs if fmt == "pack2" else torch.zeros((2, 64, 512), dtype=torch.int8)
        scale = None if fmt == "pack2" else torch.ones(2)
        with _chip_smoke().plain_versions_barred():
            with pytest.raises(RuntimeError, match="plain version"):
                wire.exchange(values, 64 * 512, (64 * 512,), scale=scale)
        assert wire.exchange(values, 64 * 512, (64 * 512,), scale=scale).shape == (64 * 512,)


def test_phase_ring_rehearses_on_the_cpu(monkeypatch):
    """The ring phase's checks at a small size on the CPU with the plain
    versions: ring against monolithic on each wire, pack8 against the sum
    in the ring's order and within its bound, the bucket against the
    per-leaf exchanges. Only the launch counts cannot hold without a card."""
    import torch

    cs = _chip_smoke()
    check = cs.check

    def no_launch_counts(cond, msg):
        if "launched" not in msg:
            check(cond, msg)

    monkeypatch.setattr(cs, "check", no_launch_counts)
    report = {}
    cs.phase_ring(torch, lambda fn, **kw: (fn(), {"ms": 0.0})[1], report, dev="cpu",
                  n=70003, layer_shapes=[(2560,), (64, 511), (300, 257)])
    ring = report["ring"]
    assert {(r["wire"], r["elastic"], r["rows"]) for r in ring["per_leaf"]} == {
        (w, e, rows) for w in ("pack2", "golomb", "pack8") for e in (False, True)
        for rows in cs.RING_ROWS if not (w == "pack8" and e)}
    pack8 = [r for r in ring["per_leaf"] if r["wire"] == "pack8"]
    assert all(r["max_abs_diff"] <= r["bound"] for r in pack8)
    assert [b["wire"] for b in ring["bucket"]] == ["pack2", "golomb", "pack8"]



def _rehearse(cs, monkeypatch):
    """chip_smoke.py on the CPU: the plain versions allowed, and the launch
    counts' checks (which need a card) left out."""
    import contextlib

    check = cs.check

    def checked(cond, msg):
        if "launches" not in msg:
            check(cond, msg)

    monkeypatch.setattr(cs, "check", checked)
    monkeypatch.setattr(cs, "plain_versions_barred", contextlib.nullcontext)


def test_phase_mamba_trainer_rehearses_on_the_cpu(monkeypatch, capsys):
    """The mamba2 phase's control flow at the smoke size on the CPU: run A,
    run B dying as injected at step 3 with its step-2 checkpoint, the
    restart in a fresh process whose step-4 checkpoint holds run A's
    parameters and EF residual bit for bit, and the elastic resume at M = 2
    to step 6. Only the launch counts cannot hold without a card."""
    import torch

    cs = _chip_smoke()
    _rehearse(cs, monkeypatch)
    report = {}
    cs.phase_mamba_trainer(torch, report, {k: 0 for k in cs.REPLACES}, dev="cpu")
    out = report["mamba_trainer"]
    assert out["run_b"]["died"] == "injected failure at step 3"
    assert out["restart"]["differ"] == 0 and len(out["restart"]["save_s"]) == 1
    assert out["elastic"]["step"] == 6 and len(out["elastic"]["loss"]) == 1
    assert out["run_a"]["leaves"] == 16
    printed = capsys.readouterr().out
    assert "[loop] resumed from step 2" in printed and "[loop] resumed from step 4" in printed
    assert "a fresh process" in printed


def test_phase_zoo_smoke_rehearses_on_the_cpu(monkeypatch):
    """The zoo phase at the smoke size on the CPU: every config cut to
    its ZOO_LAYERS entry (at most its smoke depth) through the launcher,
    and the launcher's own get_config put back afterwards."""
    import torch

    from repro_torch.launch import train as launch

    cs = _chip_smoke()
    _rehearse(cs, monkeypatch)
    get_config = launch.get_config
    report = {}
    cs.phase_zoo(torch, report, {k: 0 for k in cs.REPLACES}, dev="cpu")
    assert {a: (r["leaves"], r["kv_heads"], r["layers"]) for a, r in report["zoo"].items()} == {
        "qwen2.5-32b": (15, 2, 2), "granite-34b": (12, 1, 2), "qwen2-moe-a2.7b": (19, 4, 2),
        "gemma3-27b": (74, 2, 8), "hubert-xlarge": (12, 4, 2)}
    assert cs.ZOO_LAYERS == {"qwen2.5-32b": 2, "granite-34b": 2, "qwen2-moe-a2.7b": 2,
                             "gemma3-27b": 8, "hubert-xlarge": 48}
    assert launch.get_config is get_config


def test_phase_zoo_serve_rehearses_on_the_cpu(monkeypatch):
    """The zoo's serving phase at the smoke size on the CPU: the launcher's
    loop, the prefill and decode against the full forward within
    DECODE_REL_TOL for qwen2.5-32b, qwen2-moe-a2.7b and gemma3-27b (its
    rings of 8 slots crossed), and hubert-xlarge's finite encoder probe."""
    import torch

    cs = _chip_smoke()
    _rehearse(cs, monkeypatch)
    report = {}
    cs.phase_zoo_serve(torch, report, {k: 0 for k in cs.REPLACES}, dev="cpu")
    out = report["zoo_serve"]
    assert list(out) == list(cs.ZOO_SERVE) + ["hubert-xlarge"]
    for arch in cs.ZOO_SERVE:
        assert out[arch]["loop"]["decode_steps"] == 47 and out[arch]["loop"]["updates"] == 0
        assert out[arch]["decode_vs_forward"]["rel_err"] <= cs.DECODE_REL_TOL
    assert out["gemma3-27b"]["prefill"]["cache_depths"] == [8, 40]
    assert out["gemma3-27b"]["decode_vs_forward"]["windows"] == [8]
    assert out["hubert-xlarge"]["probe"]["frames"] == 40


def test_phase_mamba_serve_rehearses_on_the_cpu(monkeypatch):
    """The mamba2 serving phase at the smoke size on the CPU: the launcher's
    loop with 4 update rounds, the prefill, and decode against the full
    forward within the phase's bf16 and float32 tolerances."""
    import torch

    cs = _chip_smoke()
    _rehearse(cs, monkeypatch)
    report = {}
    cs.phase_mamba_serve(torch, report, {k: 0 for k in cs.REPLACES}, dev="cpu")
    out = report["mamba_serve"]
    assert out["loop"]["updates"] == 4
    assert out["float32"]["decode_vs_forward"]["rel_err"] <= cs.MAMBA_DECODE_F32_REL_TOL


def test_checkpoint_round_trip_rehearses_on_the_cpu():
    """The trainer phase's full-width round trip at the smoke size: saved,
    restored into a fresh state of other values, bit for bit; its temporary
    directory removed."""
    import glob
    import tempfile

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import Model
    from repro_torch.train.state import init_state

    model = Model(get_config("qwen1.5-4b", smoke=True))
    state = init_state(model.init(0, "cpu"), server="majority_vote", seed=3)
    before = set(glob.glob(tempfile.gettempdir() + "/chip_smoke_ckpt_*"))
    out = _chip_smoke().checkpoint_round_trip(torch, model, state)
    assert out["leaves"] == 17 and out["gb_on_disk"] > 0
    assert set(glob.glob(tempfile.gettempdir() + "/chip_smoke_ckpt_*")) == before

def test_ulps_apart_counts_steps_on_the_number_line():
    import torch

    ulps = _chip_smoke().ulps_apart
    for dtype in (torch.bfloat16, torch.float32):
        a = torch.tensor([1.0, -1.0, 0.0, -0.0, 2.0], dtype=dtype)
        up = torch.nextafter(a.to(torch.float32), torch.tensor(9.0)).to(dtype)
        if dtype == torch.bfloat16:   # one bf16 step: the next bit pattern
            up = (a.view(torch.int16) + torch.where(a < 0, -1, 1).to(torch.int16)
                  ).view(torch.bfloat16)
        assert ulps(torch, a, a) == (0, 0)
        assert ulps(torch, a, up)[1] == 1
        assert ulps(torch, torch.tensor([0.0], dtype=dtype),
                    torch.tensor([-0.0], dtype=dtype)) == (0, 0)


def test_phase_streamed_rehearses_on_the_cpu(monkeypatch, capsys):
    """The streamed phase at the smoke sizes on the CPU: S1 through the
    launcher's loop, S2's per-leaf, repeated, bucketed and simple steps bit
    for bit and the EF runs' equal digests, S3's training, serving and
    decode within DECODE_REL_TOL; the launchers' get_config put back."""
    import torch

    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch

    cs = _chip_smoke()
    _rehearse(cs, monkeypatch)
    get_configs = launch.get_config, launch_serve.get_config
    report = {}
    cs.phase_streamed(torch, report, {k: 0 for k in cs.REPLACES}, dev="cpu")
    out = report["streamed"]
    assert (out["S1"]["leaves"], out["S1"]["exchanges_a_step"]) == (16, 2 * 13 + 3)
    assert out["S1"]["simple_need_gb"] == 2 * out["S1"]["parameters"] * 2 / 1e9
    assert [out["S2"][k]["differ"] for k in ("repeat", "bucketed", "simple")] == [0, 0, 0]
    assert out["S2"]["ef_digests_equal"] and out["S2"]["ef_bucketed"]["ef_finite"]
    assert (out["S3"]["leaves"], out["S3"]["exchanges_a_step"]) == (14, 2 * 12 + 2)
    assert out["S3"]["decode_vs_forward"]["rel_err"] <= cs.DECODE_REL_TOL
    assert out["S3"]["serve_loop"]["decode_steps"] == 47
    assert cs.STREAMED_LAYERS == (8, 2, 8)
    assert (launch.get_config, launch_serve.get_config) == get_configs
    printed = capsys.readouterr().out
    assert "[streamed S1]" in printed and "[streamed S3]" in printed


def test_phase_jamba_rehearses_on_the_cpu(monkeypatch, capsys):
    """The jamba phase at the smoke widths on the CPU: J1's streamed step
    through the launcher on the card cut (positions 2-4: mamba + dense,
    mamba + MoE, attention without RoPE), its ledger, serving the trained
    state through the launcher with decode against the full forward, and
    the above-2^31 check's control flow at a small size; the launchers'
    get_config and Model put back."""
    import torch

    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch

    cs = _chip_smoke()
    _rehearse(cs, monkeypatch)
    saved = launch.get_config, launch_serve.get_config, launch_serve.Model
    report = {}
    cs.phase_jamba(torch, report, {k: 0 for k in cs.REPLACES}, dev="cpu")
    out = report["jamba"]
    j1 = out["J1"]
    assert j1["config"] == "jamba-1.5-large-398b-smoke@p2-4" and j1["layers"] == 3
    assert j1["exchanges_a_step"] == 18 + 19 + 9 + 3
    assert j1["nnz_dropped"] == 0.0
    assert out["serve"]["decode_vs_forward"]["rel_err"] <= cs.MAMBA_DECODE_REL_TOL
    assert out["serve"]["decode_vs_forward"]["argmax_agree"] == 1.0
    assert out["serve"]["loop"]["decode_steps"] == 47
    huge = out["above_2_31"]
    assert huge["bytes_differ"] == {"sparsign_pack2bit": 0, "unpack2bit_sum": 0,
                                    "vote_update": 0}
    assert huge["vote_nonzero"] > 0 and huge["weights_moved"] > 0
    assert cs.HUGE_N == 3_221_225_472 and cs.HUGE_N % cs.HUGE_CHUNK == 0
    assert cs.HUGE_BASE + cs.HUGE_N > 2 ** 32 > cs.HUGE_BASE   # the counter wraps
    assert (launch.get_config, launch_serve.get_config, launch_serve.Model) == saved
    printed = capsys.readouterr().out
    assert printed.count("[jamba J1]") == 3


def test_huge_leaf_check_counts_differing_bytes(monkeypatch):
    """The above-2^31 check compares bytes: a plain version that differs in
    one coordinate is counted, so a 0 there is not vacuous."""
    import torch

    from repro_torch.kernels.vote_update import ref as vote_ref

    cs = _chip_smoke()
    real = vote_ref.vote_update_ref

    def off_by_one(w, votes, eta, quorum=1):
        out = real(w, votes, eta, quorum).clone()
        out.view(torch.int16)[0] ^= 1
        return out

    monkeypatch.setattr(vote_ref, "vote_update_ref", off_by_one)
    huge = cs.huge_leaf_check(torch, "cpu", n=2 * (1 << 14), chunk=1 << 14)
    assert huge["bytes_differ"]["vote_update"] == 2   # one byte a chunk
    assert huge["bytes_differ"]["sparsign_pack2bit"] == 0


def test_phase_analysis_rehearses_on_the_cpu(monkeypatch, capsys):
    """The analysis phase calls the gate's ``main`` on the given device,
    prints its lines as [analysis], and fails the run on a nonzero exit.
    The gate itself exits 0 on the CPU in tests/test_torch_analysis.py;
    here its ``main`` is a stand-in."""
    import torch

    from repro_torch.analysis import __main__ as gate

    cs = _chip_smoke()
    calls = []

    def main(argv):
        calls.append(argv)
        print("repolint: 3 checks, 0 findings")
        return 0 if len(calls) == 1 else 1

    monkeypatch.setattr(gate, "main", main)
    report = {}
    cs.phase_analysis(torch, report, dev="cpu")
    assert calls == [["--device", "cpu"]] and report["analysis"]["exit"] == 0
    printed = capsys.readouterr().out
    assert "[analysis] repolint: 3 checks" in printed and "[analysis] exit 0" in printed
    with pytest.raises(RuntimeError, match="analysis gate failed"):
        cs.phase_analysis(torch, report, dev="cpu")


def test_bit_digest_tells_one_changed_bit():
    import torch

    cs = _chip_smoke()
    t = torch.randn(1000)
    u = t.clone()
    u.view(torch.int32)[517] ^= 1
    assert cs.bit_digest(torch, t) == cs.bit_digest(torch, t.clone())
    assert cs.bit_digest(torch, t) != cs.bit_digest(torch, u)
    b = t.to(torch.bfloat16)
    assert cs.bit_digest(torch, b) != cs.bit_digest(torch, -b)


def test_phase_tp_rehearses_on_the_cpu(monkeypatch, capsys):
    """The tensor-parallel phase at the smoke size on the CPU: the slice
    holds on small slices (rows 4 and 14 among them) and the short runs, the
    launcher's M = 4 x T = 2 run with wire bytes at the slice ledger, the
    injected fixed-budget rounds at T = 2 equal to T = 1 bit for bit, the
    paper's round (sign, TernGrad, elastic bit for bit; golomb under
    target_sparsity and 1-bit L2 QSGD within the flip bound), the bucketed
    uplink and the ring (the 2-bit gather bit for bit against T = 1, Golomb
    and pack8 against the per-leaf T = 2 run) and the launcher's
    ``--bucketed`` and ``--ring`` steps, the float32
    gradients no farther from float64 than TP_F64_RATIO times T = 1's, and
    the T = 2 checkpoint restored at T = 1."""
    import torch

    cs = _chip_smoke()
    _rehearse(cs, monkeypatch)
    report = {}

    def stub_timer(fn, **kw):
        fn()
        return {"ms": 1.0, "p25": 1.0, "p75": 1.0}

    cs.phase_tp(torch, report, {k: 0 for k in cs.REPLACES}, dev="cpu", timer=stub_timer,
                slice_shapes={"w_up": (8, 96), "lm_head": (8, 256)})
    out = report["tp"]
    assert out["full"]["messages_a_worker"] == 27 and out["full"]["model_ranks"] == 2
    assert out["full"]["wire_bytes_per_device"] <= out["full"]["whole_leaf_ledger"]
    assert set(out["slices"]) == {"w_up", "lm_head"}
    assert all(r["max_abs_err"] == 0 for s in out["slices"].values() for r in s.values())
    assert [out["injected"][k]["differ"] for k in ("fixed psum", "fixed allgather_packed")] \
        == [0, 0]
    assert out["injected"]["scaled_sign_ef psum"]["moved_alike"]
    assert set(out["own_gradients"]) == {"float32", "bfloat16"}
    assert all(b <= cs.TP_F64_RATIO * a + 1e-7
               for a, b in zip(out["float64"]["t1_err"], out["float64"]["t2_err"]))
    assert out["checkpoint_t2_to_t1"]
    assert all(label in out["slices"]["lm_head"] for label in cs.TP_NEW_MAPS.values())
    assert out["short_runs"]["held"] > 0
    rounds = out["round"]
    assert len(rounds) == 5 and all(r["nnz_dropped"] in (None, 0.0) for r in rounds.values())
    assert [rounds[k]["differ"] for k in ("sign psum", "terngrad psum",
                                          "elastic sparsign allgather_packed")] == [0, 0, 0]
    assert all(r["flips"] <= cs.TP_FLIP_BOUND * r["coords"] for r in rounds.values())
    bucketed = {k: r for k, r in out["bucketed"].items() if "reference" not in k}
    assert len(bucketed) == 10 and len(out["bucketed"]) == 16
    assert all(r["nnz_dropped"] in (None, 0.0) for r in out["bucketed"].values())
    assert all(r["differ_t1"] == 0 for k, r in bucketed.items() if k.startswith("sparsign "))
    assert all(r["differ_per_leaf"] == 0 for r in bucketed.values())
    assert all(r["buckets"] > 1 for k, r in bucketed.items() if k.endswith("capped"))
    assert set(out["launcher"]) == {"--bucketed", "--ring"}
    assert out["launcher"]["--bucketed"]["buckets"] > 1
    printed = capsys.readouterr().out
    assert "[tp] qwen1.5-4b" in printed and "[tp] launcher --ring" in printed


def test_sass_loops_hot_path_draws_in_line_and_skips_the_rare_blocks():
    """The hot path runs from the loop's head to its branch back over forward
    branches inside the loop: of the paths that draw the most uniforms in
    line (I2FP) it takes the shortest, so it skips a block behind
    `if (rare)` (an out-of-line call) but not the drawing, and never leaves
    the loop by a branch past its end."""
    listing = """
        Function : _Z6kernelPf
        /*0000*/                   MOV R1, R2 ;
        /*0010*/                   IADD3 R2, R2, 0x1, RZ ;
        /*0020*/              @!P3 BRA 0x50 ;
        /*0030*/                   I2FP.F32.U32 R5, R5 ;
        /*0040*/                   FMUL R5, R5, 2.3283064365386962891e-10 ;
        /*0050*/              @!P0 BRA 0x80 ;
        /*0060*/                   CALL.REL.NOINC 0x200 ;
        /*0070*/                   FFMA R3, R3, R4, R5 ;
        /*0080*/                   STG.E [R8], R3 ;
        /*0090*/               @P1 BRA 0xf0 ;
        /*00a0*/               @P2 BRA 0x10 ;
        /*00b0*/                   EXIT ;
"""
    loop = _chip_smoke().sass_loops(listing)["_Z6kernelPf"]["loops"][0]
    assert (loop["instructions"], loop["straight"], loop["hot"]) == (10, 10, 8)
    assert loop["hot_by_opcode"] == {"BRA": 4, "IADD3": 1, "I2FP": 1, "FMUL": 1, "STG": 1}
