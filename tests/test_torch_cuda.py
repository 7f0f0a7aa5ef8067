"""The port's CUDA kernels against their plain versions on the card, bit for
bit. Needs an NVIDIA GPU (``cuda`` marker; skips without one). Imports no
JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.dist.collectives import ParticipationSpec
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ef_server.ops import ef_server_op
from repro_torch.kernels.ef_server.ref import ef_server_ref
from repro_torch.kernels.golomb import ref as golomb_ref
from repro_torch.kernels.golomb.kernel import ungolomb_sum_cuda
from repro_torch.kernels.golomb.ops import (golomb_pack_op, sparsign_golomb_op,
                                            ungolomb_sum_op, ungolomb_wsum_op)
from repro_torch.kernels.common import to_2d
from repro_torch.kernels.pack2bit.ops import (pack2bit_op, unpack2bit_op, unpack2bit_sum_op,
                                              unpack2bit_wsum_op)
from repro_torch.kernels.pack2bit.ref import (pack2bit_ref, unpack2bit_ref, unpack2bit_sum_ref,
                                              unpack2bit_wsum_ref)
from repro_torch.kernels.pack8.ops import qsgd8_pack8_op, unpack8_sum_op
from repro_torch.kernels.pack8.ref import qsgd8_pack8_ref, unpack8_sum_ref
from repro_torch.kernels.sparsign.ops import sparsign_op
from repro_torch.kernels.sparsign.ref import sparsign_ref
from repro_torch.kernels.sparsign_pack2bit.ops import sparsign_pack2bit_op
from repro_torch.kernels.sparsign_pack2bit.ref import sparsign_pack2bit_ref
from repro_torch.kernels.ternary.ops import ternary_compress_op, ternary_pack2bit_op
from repro_torch.kernels.ternary.ref import ternary_compress_ref, ternary_pack2bit_ref
from repro_torch.kernels.ternary.rules import RULES
from repro_torch.kernels.vote_update.ops import vote_update_op, weighted_vote_update_op
from repro_torch.kernels.vote_update.ref import vote_update_ref, weighted_vote_update_ref
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import Model
from repro_torch.serve.decode import (build_update_ingest, encode_weight_update,
                                      encode_weight_update8)
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step


def tbits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    if t.dtype == torch.float32:
        return t.view(torch.int32).numpy()
    return t.numpy()


def grad_like(n, seed):
    g = np.random.RandomState(seed).randn(n).astype(np.float32) * 0.4
    g[::97] = 0.0
    g[1::97] = -0.0
    return g


def ef_inputs(n, seed):
    rng = np.random.RandomState(seed)
    d = rng.randn(n).astype(np.float32)
    e = (rng.randn(n) * 0.1).astype(np.float32)
    d[:4], e[:4] = [0.0, -0.0, -0.0, 0.0], [-0.0, -0.0, 0.0, 0.0]
    d[4], d[5], e[6] = np.nan, 1.0, -np.nan
    return d, e


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(cuda_device):
    """Each CUDA kernel against its plain version on the card, bit for bit."""
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.from_numpy(grad_like(3 * 4099, 1)).to(cuda_device, dtype).reshape(3, 4099)
        seeds = torch.tensor([1, 2, 0xFFFFFFFF], device=cuda_device)
        budget = torch.tensor([0.5, 1.0, 4.0], device=cuda_device)
        np.testing.assert_array_equal(tbits(sparsign_op(g, budget, seeds, 7)),
                                      tbits(sparsign_ref(g, budget, seeds, 7)))
        w = torch.randn(4099, device=cuda_device).to(dtype)
        for vdt in (torch.int8, torch.int16, torch.int32):   # int16: 128+ workers' sums
            v = torch.randint(-5, 6, (4099,), device=cuda_device, dtype=vdt)
            np.testing.assert_array_equal(tbits(vote_update_op(w, v, 0.01, quorum=2)),
                                          tbits(vote_update_ref(w, v, 0.01, 2)))
    d, e = (torch.from_numpy(a).to(cuda_device) for a in ef_inputs(4099, 2))
    s = torch.tensor([0.5], device=cuda_device)
    for a, b in zip(ef_server_op(d, e, s), ef_server_ref(d, e, s)):
        np.testing.assert_array_equal(tbits(a), tbits(b))


@pytest.mark.cuda
def test_ternary_and_weighted_vote_kernels_match_plain_versions_on_card(cuda_device):
    """csrc/ternary.cu for each rule and csrc/weighted_vote_update.cu against
    their plain versions on the card, bit for bit (noisy_sign included: both
    take CUDA's logf, cosf and sqrtf)."""
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.from_numpy(grad_like(3 * 4099, 3)).to(cuda_device, dtype).reshape(3, 4099)
        g[0, :4] = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e-30])
        seeds = torch.tensor([1, 2, 0xFFFFFFFF], device=cuda_device)
        param = torch.tensor([0.5, 1.0, float("nan")], device=cuda_device)
        for rule in RULES:
            np.testing.assert_array_equal(
                tbits(ternary_compress_op(g, param, seeds, 2**32 - 9, rule=rule)),
                tbits(ternary_compress_ref(g, param, seeds, 2**32 - 9, rule=rule)))
        w = torch.randn(4099, device=cuda_device).to(dtype)
        v = torch.randint(-5, 6, (4099,), device=cuda_device).float() * 0.5
        v[:3] = torch.tensor([-0.0, float("nan"), 0.0])
        for wtot in (torch.tensor(3.0, device=cuda_device), torch.rand(4099, device=cuda_device) * 5):
            np.testing.assert_array_equal(
                tbits(weighted_vote_update_op(w, v, wtot, 0.01, q_frac=0.25)),
                tbits(weighted_vote_update_ref(w, v, wtot, 0.01, 0.25)))


@pytest.mark.cuda
def test_wire_kernels_match_plain_versions_on_card(cuda_device):
    """The fused compress -> 2-bit kernels (every rule, f32 and bf16, the
    canonical pad) and the decode-sums (M = 1, 3, zero weights) against their
    plain versions on the card, bit for bit."""
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.from_numpy(grad_like(4099, 5)).to(cuda_device, dtype)
        g[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
        np.testing.assert_array_equal(tbits(sparsign_pack2bit_op(g, 2.0, 0xFFFFFFFF, 9)),
                                      tbits(sparsign_pack2bit_ref(g, 2.0, 0xFFFFFFFF, 9)))
        for rule in RULES:
            np.testing.assert_array_equal(
                tbits(ternary_pack2bit_op(g, 0.5, 3, 2**32 - 9, rule=rule)),
                tbits(ternary_pack2bit_ref(g, 0.5, 3, 2**32 - 9, rule=rule)))
    # the shared encoder's edges (csrc/pack2_encode.cuh, tiles of 16 rows):
    # sizes about a row and a tile, a gradient one element off 16-byte
    # alignment, a counter base that wraps inside a thread's span, params
    # -1, 0, NaN, inf and 2^24, subnormal gradients; sparsign_pack2bit equal
    # to ternary_pack2bit's sparsign rule
    tile = 16 * 512
    for n, dtype, off, scale in ((1, torch.bfloat16, 0, 1.0), (511, torch.float32, 0, 1.0),
                                 (512, torch.bfloat16, 0, 1.0), (513, torch.bfloat16, 1, 1.0),
                                 (tile - 1, torch.bfloat16, 0, 1.0),
                                 (tile, torch.float32, 0, 1.0),
                                 (tile + 1, torch.bfloat16, 1, 1.0),
                                 (2 * tile + 3, torch.bfloat16, 0, 2.0**-130),
                                 (2 * tile + 3, torch.float32, 0, 2.0**-130)):
        g = (torch.from_numpy(grad_like(n + off, 6)) * scale).to(cuda_device, dtype)[off:]
        for p in (-1.0, 0.0, float("nan"), float("inf"), 2.0**24, 0.5, 2.0**-20, 2.0**126):
            for rule in RULES:
                k = ternary_pack2bit_op(g, p, 7, 2**32 - 7, rule=rule)
                np.testing.assert_array_equal(
                    tbits(k), tbits(ternary_pack2bit_ref(g, p, 7, 2**32 - 7, rule=rule)),
                    err_msg=f"{rule} n={n} {dtype} offset {off} scale {scale} param {p}")
                if rule == "sparsign":
                    np.testing.assert_array_equal(tbits(sparsign_pack2bit_op(g, p, 7, 2**32 - 7)),
                                                  tbits(k))
    for m in (1, 3):
        p = torch.randint(0, 256, (m, 64, 128), device=cuda_device, dtype=torch.uint8)
        w = torch.tensor([0.0, 0.3, 1.5][:m], device=cuda_device)
        np.testing.assert_array_equal(tbits(unpack2bit_sum_op(p, 64 * 512 - 5, (64 * 512 - 5,))),
                                      tbits(unpack2bit_sum_ref(p).reshape(-1)[:64 * 512 - 5]))
        np.testing.assert_array_equal(
            tbits(unpack2bit_wsum_op(p, w, 64 * 512, (64, 512))),
            tbits(unpack2bit_wsum_ref(p, w)))


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [1, 2])
def test_trainer_step_on_card_matches_plain_versions(cuda_device, tau):
    """One smoke-size trainer step at M = 4 on the packed wire through the
    kernels, and through the plain versions (backend='torch') on the card:
    the same parameters, bit for bit, and every wire kernel launched (with
    tau = 2 the local steps' sparsign kernel too)."""
    model = Model(get_config("qwen1.5-4b", smoke=True))
    comp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0),
                             server="majority_vote", local_steps=tau, local_budget=10.0)
    rng = np.random.RandomState(0)
    lead = (tau,) if tau > 1 else ()
    batch = {"inputs": rng.randint(0, 256, lead + (4, 16)).astype(np.int32),
             "labels": rng.randint(0, 256, lead + (4, 16)).astype(np.int32),
             "positions": np.broadcast_to(np.arange(16, dtype=np.int32), lead + (4, 16)).copy()}
    out = {}
    for backend in (None, "torch"):
        step = build_train_step(model, TrainStepConfig(
            compression=comp, lr=LrSchedule(base=0.05), local_lr=0.01,
            vote_impl="allgather_packed", backend=backend), make_mesh((4,), ("data",)))
        state = init_state(model.init(0, device=cuda_device), server=comp.server, seed=1)
        reset_launch_counts()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        out[backend] = [tbits(t) for t in tree_leaves(state.params)]
        if backend is None:
            assert counts["sparsign_pack2bit"] == 15 * 4 and counts["unpack2bit_sum"] == 15
            assert counts["sparsign"] == (15 * 4 * tau if tau > 1 else 0)
        else:
            assert not any(counts.values())
    for a, b in zip(out[None], out["torch"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_golomb_kernels_match_plain_versions_on_card(cuda_device):
    """The Golomb/Rice encoders (sparsign of f32 and bf16 gradients near the
    top of the counter, with +-0/NaN/+-inf; an int8 view; a message past
    capacity; a lone last nonzero) and the decode-sums (M = 1, 3 with a
    masked worker, zero and fractional weights) against their plain versions
    on the card, bit for bit."""
    p = 0.05
    for n in (1, 4099, 70001):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.from_numpy(grad_like(n, n)).to(cuda_device, dtype)
            g[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])[:n]
            for budget in (0.12, 3.0):   # near the plan; past the capacity
                want = golomb_ref.golomb_encode_ref(sparsign_ref(g, budget, 5, 2**32 - 9), p=p)
                np.testing.assert_array_equal(
                    tbits(sparsign_golomb_op(g, budget, 5, 2**32 - 9, p=p)), tbits(want))
    t = torch.zeros(70001, dtype=torch.int8, device=cuda_device)
    t[-1] = 1
    for x in (t, torch.from_numpy(np.random.RandomState(1).randint(-1, 2, 70001).astype(
            np.int8)).to(cuda_device)):
        np.testing.assert_array_equal(tbits(golomb_pack_op(x, p=p)),
                                      tbits(golomb_ref.golomb_encode_ref(x, p=p)))
    n = 70001
    g = torch.from_numpy(grad_like(n, 7)).to(cuda_device)
    for m in (1, 3):
        msgs = torch.stack([sparsign_golomb_op(g, 0.12, s, p=p) for s in range(m)])
        if m == 3:
            msgs[1] = 0
        w = torch.tensor([0.0, 0.3, 1.5][:m], device=cuda_device)
        np.testing.assert_array_equal(tbits(ungolomb_sum_op(msgs, n, (n,), p=p)),
                                      tbits(golomb_ref.ungolomb_sum_ref(msgs, n, (n,), p=p)))
        np.testing.assert_array_equal(tbits(ungolomb_wsum_op(msgs, w, n, (n,), p=p)),
                                      tbits(golomb_ref.ungolomb_wsum_ref(msgs, w, n, (n,), p=p)))


@pytest.mark.cuda
def test_golomb_kernels_stress_cases_on_card(cuda_device):
    """The Golomb kernels' designs at their edges, bit for bit against the
    plain versions: a message of 2^23 coordinates (2,048 encoder tiles, more
    than the card holds at once, so the look-back crosses waves); codes on
    each side of an output-tile edge (2,048 coordinates) and a unary run that
    crosses several empty 4,096-coordinate encoder tiles and a tile edge; M =
    20 with the masked worker in the middle."""
    p, n = 0.05, 1 << 23
    b = golomb_ref.rice_b(p)
    g = torch.from_numpy(grad_like(n, 3)).to(cuda_device, torch.bfloat16)
    want = golomb_ref.golomb_encode_ref(sparsign_ref(g, 0.12, 9), p=p)
    np.testing.assert_array_equal(tbits(sparsign_golomb_op(g, 0.12, 9, p=p)), tbits(want))
    edges = torch.zeros(70001, dtype=torch.int8, device=cuda_device)
    edges[[2047, 2048, 4095, 4096, 6143, 6144 + 5 * 4096 + 3, 70000]] = torch.tensor(
        [1, -1, -1, 1, 1, -1, 1], dtype=torch.int8, device=cuda_device)
    coded = golomb_pack_op(edges, p=p)
    np.testing.assert_array_equal(tbits(coded), tbits(golomb_ref.golomb_encode_ref(edges, p=p)))
    np.testing.assert_array_equal(tbits(ungolomb_sum_op(coded[None], 70001, (70001,), p=p)),
                                  tbits(edges.to(torch.int32)))
    m, n = 20, 70001
    g = torch.from_numpy(grad_like(n, 4)).to(cuda_device)
    msgs = torch.stack([sparsign_golomb_op(g, 0.12, s, p=p) for s in range(m)])
    msgs[m // 2] = 0
    w = torch.from_numpy(np.random.RandomState(5).rand(m).astype(np.float32) * 2).to(cuda_device)
    stats = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    np.testing.assert_array_equal(tbits(ungolomb_sum_cuda(msgs, n, b=b, stats=stats)),
                                  tbits(golomb_ref.ungolomb_sum_ref(msgs, n, (n,), p=p)))
    assert int(stats[0]) == 0
    np.testing.assert_array_equal(tbits(ungolomb_wsum_op(msgs, w, n, (n,), p=p)),
                                  tbits(golomb_ref.ungolomb_wsum_ref(msgs, w, n, (n,), p=p)))


@pytest.mark.cuda
@pytest.mark.parametrize("elastic", [False, True])
def test_golomb_trainer_step_on_card_matches_plain_versions(cuda_device, elastic):
    """One smoke-size trainer step at M = 4 on the golomb wire through the
    kernels and through the plain versions on the card: the same parameters,
    bit for bit, the golomb kernels launched, and the same parameters as the
    2-bit packed wire's step."""
    model = Model(get_config("qwen1.5-4b", smoke=True))
    rng = np.random.RandomState(0)
    batch = {"inputs": rng.randint(0, 256, (4, 16)).astype(np.int32),
             "labels": rng.randint(0, 256, (4, 16)).astype(np.int32),
             "positions": np.broadcast_to(np.arange(16, dtype=np.int32), (4, 16)).copy()}
    part = (ParticipationSpec(weights=(1.5, 0.5, 2.0, 1.0), dropout=0.25) if elastic else None)
    out = {}
    for name, backend in (("sparsign_golomb", None), ("sparsign_golomb", "torch"),
                          ("sparsign", None)):
        comp = CompressionConfig(compressor=name, budget=BudgetConfig(
            kind="target_sparsity", value=0.05), server="majority_vote")
        step = build_train_step(model, TrainStepConfig(
            compression=comp, lr=LrSchedule(base=0.05), vote_impl="allgather_packed",
            backend=backend, participation=part), make_mesh((4,), ("data",)))
        state = init_state(model.init(0, device=cuda_device), server=comp.server, seed=1)
        reset_launch_counts()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        out[(name, backend)] = [tbits(t) for t in tree_leaves(state.params)]
        if name == "sparsign_golomb":
            assert float(metrics["nnz_dropped"]) == 0.0
            if backend is None:
                decode = "ungolomb_wsum" if elastic else "ungolomb_sum"
                assert counts["sparsign_golomb"] == 15 * 4 and counts[decode] == 15
            else:
                assert not any(counts.values())
    for key in (("sparsign_golomb", "torch"), ("sparsign", None)):
        for a, b in zip(out[("sparsign_golomb", None)], out[key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_pack_unpack_and_pack8_kernels_match_plain_versions_on_card(cuda_device):
    """pack2bit and unpack2bit (ternary and arbitrary int8 bytes, odd sizes),
    qsgd8_pack8 (f32 and bf16, +-0/NaN/+-inf, a counter base near 2^32, a
    zero and a NaN scale; every bf16 bit pattern at five scales, sizes about
    a tile, off 16-byte alignment) and unpack8_sum (M = 1, 4, 20; zero scales with negative
    levels) against their plain versions on the card, bit for bit."""
    rng = np.random.RandomState(9)
    for n in (1, 4099, 70001):
        for lo, hi in ((-1, 2), (-128, 128)):
            t = torch.from_numpy(rng.randint(lo, hi, n).astype(np.int8)).to(cuda_device)
            packed = pack2bit_op(t)
            np.testing.assert_array_equal(tbits(packed), tbits(pack2bit_ref(to_2d(t)[0])))
            np.testing.assert_array_equal(tbits(unpack2bit_op(packed, n, (n,))),
                                          tbits(unpack2bit_ref(packed).reshape(-1)[:n]))
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.from_numpy(grad_like(n, n)).to(cuda_device, dtype)
            g[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])[:n]
            for scale in (0.0, 1e-3, 0.05, float("nan")):
                np.testing.assert_array_equal(
                    tbits(qsgd8_pack8_op(g, scale, 0xFFFFFFFF, 2**32 - 9)),
                    tbits(qsgd8_pack8_ref(g, scale, 0xFFFFFFFF, 2**32 - 9)))
    # qsgd8_pack8's edges (csrc/pack8.cu): every bf16 bit pattern on the
    # hoisted division (scales 1e-20, 0.01, 2 - 2^-23) and on __fdiv_rn (3, NaN);
    # sizes about a tile, a gradient off 16-byte alignment, a counter wrapping
    every_bf16 = torch.arange(-2**15, 2**15, dtype=torch.int16,
                              device=cuda_device).view(torch.bfloat16)
    for scale in (1e-20, 0.01, 2.0 - 2.0**-23, 3.0, float("nan")):
        np.testing.assert_array_equal(tbits(qsgd8_pack8_op(every_bf16, scale, 7, 2**32 - 7)),
                                      tbits(qsgd8_pack8_ref(every_bf16, scale, 7, 2**32 - 7)))
    for n in (511, 8193):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.from_numpy(grad_like(n + 1, n)).to(cuda_device, dtype)
            for x in (g[1:].clone(), g[1:]):
                np.testing.assert_array_equal(tbits(qsgd8_pack8_op(x, 0.01, 5, 2**32 - 7)),
                                              tbits(qsgd8_pack8_ref(x, 0.01, 5, 2**32 - 7)))
    for m in (1, 4, 20):
        lv = torch.randint(-127, 128, (m, 96, 512), device=cuda_device, dtype=torch.int8)
        sc = torch.rand(m, device=cuda_device) * 0.1
        sc[::2] = 0.0
        want = unpack8_sum_ref(lv, sc)
        np.testing.assert_array_equal(tbits(unpack8_sum_op(lv, sc, 96 * 512, (96, 512))),
                                      tbits(want))
        assert not bool(torch.signbit(want[want == 0]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 9])
def test_decode_sums_write_and_accumulate_into_an_output_on_card(m, cuda_device):
    """The decode-sums' in-place form, the ring's hop: into each output
    dtype, fresh and added into a nonzero accumulator (+-0.0 among it), bit
    for bit the plain versions', with zero weights and scales."""
    rows, n = 64, 64 * 512
    p = torch.randint(0, 256, (m, rows, 128), device=cuda_device, dtype=torch.uint8)
    lv = torch.randint(-127, 128, (m, rows, 512), device=cuda_device, dtype=torch.int8)
    w = torch.rand(m, device=cuda_device)
    w[::2] = 0.0
    for accumulate in (False, True):
        for dtype in (torch.int8, torch.int16, torch.int32):
            a0 = torch.randint(-50, 51, (n,), device=cuda_device).to(dtype)
            got = unpack2bit_sum_op(p, n, (n,), out=a0.clone(), accumulate=accumulate)
            want = unpack2bit_sum_ref(p, out=a0.clone(), accumulate=accumulate)
            np.testing.assert_array_equal(tbits(got), tbits(want.reshape(-1)))
        a0 = torch.randn(n, device=cuda_device)
        a0[::5], a0[1::5] = -0.0, 0.0
        for op, ref, data in ((unpack2bit_wsum_op, unpack2bit_wsum_ref, p),
                              (unpack8_sum_op, unpack8_sum_ref, lv)):
            got = op(data, w, n, (n,), out=a0.clone(), accumulate=accumulate)
            want = ref(data, w, out=a0.clone(), accumulate=accumulate)
            np.testing.assert_array_equal(tbits(got), tbits(want.reshape(-1)))


@pytest.mark.cuda
def test_two_pass_pack2_chain_on_card_matches_the_fused_kernel(cuda_device):
    """engine.compress_leaf on the 2-bit wire for a row without a fused
    kernel (a copy of ``sign`` with none): the ternary kernel, then the
    pack2bit kernel, the bytes of the fused kernel."""
    import dataclasses

    from repro_torch.core import engine
    from repro_torch.core.compressors import SPECS
    from repro_torch.dist.collectives import make_vote_wire

    name = "sign_two_pass"
    SPECS[name] = dataclasses.replace(SPECS["sign"], name=name, fused_pack_op=None)
    try:
        wire = make_vote_wire("allgather_packed", make_mesh((4,), ("data",)))
        g = torch.from_numpy(grad_like(70001, 11)).to(cuda_device, torch.bfloat16)
        reset_launch_counts()
        two = engine.compress_leaf(g, CompressionConfig(compressor=name), 5, wire=wire).values
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["ternary"] == counts["pack2bit"] == 1
        fused = engine.compress_leaf(g, CompressionConfig(compressor="sign"), 5, wire=wire).values
        np.testing.assert_array_equal(tbits(two), tbits(fused))
    finally:
        del SPECS[name]


@pytest.mark.cuda
@pytest.mark.parametrize("elastic", [False, True])
def test_pack8_trainer_step_on_card_matches_plain_versions(cuda_device, elastic):
    """One smoke-size qsgd8 step at M = 4 with the mean server on the pack8
    wire through the kernels, and through the plain versions on the card, and
    on the decoded psum: the same parameters, bit for bit, with 60
    qsgd8_pack8 and 15 unpack8_sum launches on the pack8 wire."""
    model = Model(get_config("qwen1.5-4b", smoke=True))
    rng = np.random.RandomState(0)
    batch = {"inputs": rng.randint(0, 256, (4, 16)).astype(np.int32),
             "labels": rng.randint(0, 256, (4, 16)).astype(np.int32),
             "positions": np.broadcast_to(np.arange(16, dtype=np.int32), (4, 16)).copy()}
    part = (ParticipationSpec(weights=(1.5, 0.5, 2.0, 1.0), dropout=0.25) if elastic else None)
    comp = CompressionConfig(compressor="qsgd8", server="mean")
    out = {}
    for impl, backend in (("allgather_packed", None), ("allgather_packed", "torch"),
                          ("psum", None)):
        step = build_train_step(model, TrainStepConfig(
            compression=comp, lr=LrSchedule(base=0.05), vote_impl=impl, backend=backend,
            participation=part), make_mesh((4,), ("data",)))
        state = init_state(model.init(0, device=cuda_device), server=comp.server, seed=1)
        reset_launch_counts()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        out[(impl, backend)] = [tbits(t) for t in tree_leaves(state.params)]
        if backend is None:
            assert counts["qsgd8_pack8"] == 15 * 4
            assert counts["unpack8_sum"] == (15 if impl == "allgather_packed" else 0)
        else:
            assert not any(counts.values())
    for key in (("allgather_packed", "torch"), ("psum", None)):
        for a, b in zip(out[("allgather_packed", None)], out[key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_update_ingest_on_card_matches_plain_versions(cuda_device):
    """The three downlink wires at smoke size on the card: encoded and
    ingested through the kernels (pack2bit, unpack2bit, qsgd8_pack8,
    vote_update), and through the plain versions: the same bytes and the
    same parameters, bit for bit."""
    model = Model(get_config("qwen1.5-4b", smoke=True))
    params = model.init(0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    votes = [torch.randint(-3, 4, p.shape, generator=gen, device=cuda_device,
                           dtype=torch.int32) for p in tree_leaves(params)]
    deltas = [torch.randn(p.shape, generator=gen, device=cuda_device) * 1e-3
              for p in tree_leaves(params)]
    reset_launch_counts()
    got, want = {}, {}
    for backend, out in ((None, got), ("torch", want)):
        packed = [encode_weight_update(v, backend=backend) for v in votes]
        enc8 = [encode_weight_update8(d, seed=i, backend=backend) for i, d in enumerate(deltas)]
        for wire, ups, sc, q in (("packed2bit", packed, None, 1),
                                 ("int8", [v.to(torch.int8) for v in votes], None, 2),
                                 ("packed8", [e[0] for e in enc8], [e[1] for e in enc8], 1)):
            p = [t.clone() for t in tree_leaves(params)]
            ingest = build_update_ingest(model, lr=0.05, quorum=q, wire=wire, backend=backend)
            out[wire] = [tbits(t) for t in ingest(p, ups, sc)]
        out["bytes"] = [tbits(x) for x in packed] + [tbits(e[0]) for e in enc8]
    counts = launch_counts()
    assert counts["pack2bit"] == counts["unpack2bit"] == counts["qsgd8_pack8"] == 15
    assert counts["vote_update"] == 30
    for key in got:
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_checkpoint_of_card_leaves_is_np_save_bytes(cuda_device, tmp_path, monkeypatch):
    """A state on the card saves through the pinned staging buffer (cut to a
    few KB here, so leaves cross several chunks) to the bytes np.save writes
    for the host copies (bf16 widened), and restores onto the card bit for
    bit."""
    import os

    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.state import TrainState

    monkeypatch.setattr(ckpt, "STAGE_BYTES", 4096)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    state = TrainState(
        params={"a": torch.randn(37, 129, generator=gen, device=cuda_device),
                "b": (torch.randn(3001, generator=gen, device=cuda_device).to(torch.bfloat16),)},
        ef_residual={"a": torch.randn(37, 129, generator=gen, device=cuda_device),
                     "b": (torch.zeros(3001, device=cuda_device),)},
        step=9, seed=2**32 - 1)
    path = ckpt.save(str(tmp_path / "ck"), 9, state)
    for i, (_, leaf) in enumerate(ckpt._flatten_with_path(state)):
        host = (leaf.to(torch.float32).cpu().numpy() if isinstance(leaf, torch.Tensor)
                else np.asarray(leaf))
        np.save(tmp_path / "want.npy", host)
        with open(os.path.join(path, f"leaf_{i:05d}.npy"), "rb") as f:
            assert f.read() == (tmp_path / "want.npy").read_bytes(), i
    got, _ = ckpt.restore(str(tmp_path / "ck"), state)
    assert got.step == 9 and got.seed == 2**32 - 1
    for a, b in zip(tree_leaves([got.params, got.ef_residual]),
                    tree_leaves([state.params, state.ef_residual])):
        assert a.device == b.device and a.dtype == b.dtype
        np.testing.assert_array_equal(tbits(a), tbits(b))


@pytest.mark.cuda
def test_moe_step_on_card_repeats_bit_for_bit(cuda_device):
    """One qwen2-moe-a2.7b smoke step (M = 4, 2-bit wire, majority vote) run
    twice from clones of one state gives the same bits: the MoE combine and
    the gather's backward add each token's rows expert after expert with no
    float atomics, so no run adds in another order."""
    model = Model(get_config("qwen2-moe-a2.7b", smoke=True))
    comp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=1.0),
                             server="majority_vote")
    step = build_train_step(model, TrainStepConfig(
        compression=comp, lr=LrSchedule(base=0.05), vote_impl="allgather_packed"),
        make_mesh((4,), ("data",)))
    rng = np.random.RandomState(4)
    batch = {"inputs": rng.randint(0, 256, (4, 64)).astype(np.int32),
             "labels": rng.randint(0, 256, (4, 64)).astype(np.int32),
             "positions": np.broadcast_to(np.arange(64, dtype=np.int32), (4, 64)).copy()}
    params0 = model.init(0, device=cuda_device)
    out = []
    for _ in range(2):
        params = tree_unflatten(params0, [t.clone() for t in tree_leaves(params0)])
        state = init_state(params, server=comp.server, seed=1)
        reset_launch_counts()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        assert launch_counts()["sparsign_pack2bit"] == 19 * 4
        out.append([tbits(t) for t in tree_leaves(state.params)] + [tbits(metrics["loss"])])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def _streamed_smoke(cuda_device, backend, params0):
    """One streamed llama4-scout smoke step (M = 4, 2-bit wire, majority
    vote) from a clone of ``params0``: (the parameters' bits and the loss's,
    the launch counts)."""
    from repro_torch.train.step_streamed import StreamedStepConfig, build_streamed_train_step

    model = Model(get_config("llama4-scout-17b-a16e", smoke=True))
    comp = CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=1.0),
                             server="majority_vote")
    step = build_streamed_train_step(model, StreamedStepConfig(
        compression=comp, lr=LrSchedule(base=0.05), vote_impl="allgather_packed",
        backend=backend), make_mesh((4,), ("data",)))
    rng = np.random.RandomState(4)
    batch = {"inputs": rng.randint(0, 256, (4, 64)).astype(np.int32),
             "labels": rng.randint(0, 256, (4, 64)).astype(np.int32),
             "positions": np.broadcast_to(np.arange(64, dtype=np.int32), (4, 64)).copy()}
    params = tree_unflatten(params0, [t.clone() for t in tree_leaves(params0)])
    state = init_state(params, server=comp.server, seed=1)
    reset_launch_counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    return ([tbits(t) for t in tree_leaves(state.params)] + [tbits(metrics["loss"])],
            launch_counts())


@pytest.mark.cuda
def test_streamed_step_on_card_matches_plain_versions(cuda_device):
    """The streamed step through the kernels (M x (2 x 13 + 3) encodes, one
    decode-sum and one vote_update a layer and leaf) equals the same step
    through the plain versions on the card (backend="torch", no launch),
    bit for bit."""
    params0 = Model(get_config("llama4-scout-17b-a16e", smoke=True)).init(0, device=cuda_device)
    got, counts = _streamed_smoke(cuda_device, None, params0)
    want, plain_counts = _streamed_smoke(cuda_device, "torch", params0)
    assert counts["sparsign_pack2bit"] == 4 * 29
    assert counts["unpack2bit_sum"] == counts["vote_update"] == 29
    assert not any(plain_counts.values())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_streamed_step_on_card_repeats_bit_for_bit(cuda_device):
    """The same streamed step twice from one state gives the same bits: the
    recompute, the embedding's backward and the MoE combine add in one
    order on every run."""
    params0 = Model(get_config("llama4-scout-17b-a16e", smoke=True)).init(0, device=cuda_device)
    first, _ = _streamed_smoke(cuda_device, None, params0)
    second, _ = _streamed_smoke(cuda_device, None, params0)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_wire_kernels_above_2_31_coordinates_on_card(cuda_device):
    """sparsign_pack2bit (counter base 0 and a base whose counter wraps),
    unpack2bit_sum of four messages into int8 and vote_update on one of
    jamba's 3,221,225,472-coordinate expert leaves, against their plain
    versions in 2^28-coordinate chunks: 0 bytes differ
    (``chip_smoke.huge_leaf_check``, about 45 GB of device memory)."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    huge = chip_smoke.huge_leaf_check(torch, str(cuda_device))
    assert huge["coordinates"] == 3_221_225_472 > 2 ** 31
    assert huge["bytes_differ"] == {"sparsign_pack2bit": 0, "unpack2bit_sum": 0,
                                    "vote_update": 0}
    assert huge["vote_nonzero"] > 0 and huge["weights_moved"] > 0
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_counter_map_kernels_match_plain_versions_on_card(cuda_device, dtype):
    """Rows 1, 5 (every rule), 6 and 12 on a model rank's slice of a leaf
    (the counter map): the slice's symbols are the plain versions' bit for
    bit and, for row 1, the whole leaf's at the same coordinates; runs that
    are and are not multiples of the encoders' groups, runs shorter than a
    group (the walker's short-run mode), a counter base that wraps inside
    the slice, a slice cut on a middle axis."""
    cases = [((64, 6912), 2, 1, 12345), ((37, 504), 2, 1, 7), ((8, 34), 2, 0, 2**32 - 40),
             ((5, 96, 40), 3, 2, 99), ((300, 16), 2, 1, 5), ((129, 6), 3, 2, 2**32 - 9),
             ((64, 504), 2, 1, 2**32 - 5000), ((64, 34), 2, 1, 2**32 - 5000)]
    for shape, t, rank, base in cases:
        g = torch.from_numpy(grad_like(int(np.prod(shape)), 3).reshape(shape)).to(
            cuda_device, dtype)
        dim = 1 if len(shape) == 3 else len(shape) - 1
        width = shape[dim] // t
        s = g.narrow(dim, rank * width, width).contiguous()
        leaf_run = int(np.prod(shape[dim:]))
        run = leaf_run // t
        cmap = (run, leaf_run, rank * run)
        scale = torch.tensor(0.02, device=cuda_device)
        got = sparsign_op(s, 3.0, 77, base, counter_map=cmap)
        assert torch.equal(got, sparsign_ref(s, 3.0, 77, base, counter_map=cmap))
        whole = sparsign_ref(g, 3.0, 77, base).narrow(dim, rank * width, width)
        assert torch.equal(got, whole), shape
        assert torch.equal(sparsign_pack2bit_op(s, 3.0, 77, base, counter_map=cmap),
                           sparsign_pack2bit_ref(s, 3.0, 77, base, counter_map=cmap))
        for rule in RULES:
            prm = 0.3 if rule == "noisy_sign" else 3.0
            assert torch.equal(
                ternary_pack2bit_op(s, prm, 77, base, rule=rule, counter_map=cmap),
                ternary_pack2bit_ref(s, prm, 77, base, rule=rule, counter_map=cmap)), rule
        assert torch.equal(qsgd8_pack8_op(s, scale, 77, base, counter_map=cmap),
                           qsgd8_pack8_ref(s, scale, 77, base, counter_map=cmap))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row4_and_row14_counter_maps_match_plain_versions_on_card(cuda_device, dtype):
    """The two map launches of rows 4 (``ternary_map_launch``, every rule,
    several rows with their own seeds and params) and 14
    (``golomb_encode_map_launch``, the slice capacity of its whole leaf) on
    a model rank's slice: bit for bit against their plain versions, row 4
    also the whole leaf's symbols; the cases of the rows 1, 5, 6, 12 test
    above, and each launch counted as a map launch."""
    from repro_torch.kernels import map_launch_counts
    from repro_torch.kernels.golomb.ref import sparsign_golomb_ref
    cases = [((64, 6912), 2, 1, 12345), ((37, 504), 2, 1, 7), ((8, 34), 2, 0, 2**32 - 40),
             ((5, 96, 40), 3, 2, 99), ((300, 16), 2, 1, 5), ((129, 6), 3, 2, 2**32 - 9),
             ((64, 504), 2, 1, 2**32 - 5000), ((64, 34), 2, 1, 2**32 - 5000)]
    reset_launch_counts()
    calls = 0
    for shape, t, rank, base in cases:
        g = torch.from_numpy(grad_like(int(np.prod(shape)), 4).reshape(shape)).to(
            cuda_device, dtype)
        dim = 1 if len(shape) == 3 else len(shape) - 1
        width = shape[dim] // t
        s = g.narrow(dim, rank * width, width).contiguous()
        leaf_run = int(np.prod(shape[dim:]))
        run = leaf_run // t
        cmap = (run, leaf_run, rank * run)
        for rule in RULES:
            prm = 0.3 if rule == "noisy_sign" else 3.0
            got = ternary_compress_op(s, prm, 77, base, rule=rule, counter_map=cmap)
            assert torch.equal(got, ternary_compress_ref(s, prm, 77, base, rule=rule,
                                                         counter_map=cmap)), (shape, rule)
            whole = ternary_compress_ref(g, prm, 77, base, rule=rule)
            assert torch.equal(got, whole.narrow(dim, rank * width, width)), (shape, rule)
            rows = torch.stack([s, -s])
            assert torch.equal(
                ternary_compress_op(rows, [prm, 2 * prm], [77, 78], base, rule=rule,
                                    counter_map=cmap),
                ternary_compress_ref(rows, [prm, 2 * prm], [77, 78], base, rule=rule,
                                     counter_map=cmap)), (shape, rule)
            calls += 2
        coded = sparsign_golomb_op(s, 0.5, 77, base, p=0.05, counter_map=cmap,
                                   leaf_n=g.numel())
        assert torch.equal(coded, sparsign_golomb_ref(s, 0.5, 77, base, p=0.05,
                                                      counter_map=cmap, leaf_n=g.numel()))
    torch.cuda.synchronize()
    maps = map_launch_counts()
    assert maps["ternary"] == calls and maps["sparsign_golomb"] == len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sign-psum", "terngrad-psum", "golomb", "elastic", "qsgd_1bit"])
def test_tp_round_variants_on_card_match_plain_versions(cuda_device, case):
    """One smoke-size step at M = 4 x T = 2 of the paper's round under the
    'model' axis through the kernels and through the plain versions
    (backend='torch') on the card: the same parameters bit for bit, and the
    row-4 or row-14 map launched once a worker and cut leaf."""
    from repro_torch.kernels import map_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    model = Model(get_config("qwen1.5-4b", smoke=True))
    comp, impl, kw, mapped = {
        "sign-psum": (CompressionConfig(compressor="sign"), "psum", {}, "ternary"),
        "terngrad-psum": (CompressionConfig(compressor="terngrad", server="mean"), "psum", {},
                          "ternary"),
        "golomb": (CompressionConfig(compressor="sparsign_golomb",
                                     budget=BudgetConfig(kind="target_sparsity", value=0.05)),
                   "allgather_packed", {}, "sparsign_golomb"),
        "elastic": (CompressionConfig(compressor="sparsign", budget=BudgetConfig(value=2.0)),
                    "allgather_packed",
                    {"participation": ParticipationSpec(weights=(1.5, 0.5, 2.0, 1.0),
                                                        dropout=0.25)}, "sparsign_pack2bit"),
        "qsgd_1bit": (CompressionConfig(compressor="qsgd_1bit_l2", server="mean"),
                      "allgather_packed", {}, "ternary"),
    }[case]
    rng = np.random.RandomState(0)
    batch = {"inputs": rng.randint(0, 256, (4, 16)).astype(np.int32),
             "labels": rng.randint(0, 256, (4, 16)).astype(np.int32),
             "positions": np.broadcast_to(np.arange(16, dtype=np.int32), (4, 16)).copy()}
    out = {}
    for backend in (None, "torch"):
        step = build_train_step(model, TrainStepConfig(
            compression=comp, lr=LrSchedule(base=0.05), vote_impl=impl, backend=backend, **kw),
            make_host_mesh(4, 2))
        state = step.shard_state(init_state(model.init(0, device=cuda_device),
                                            server=comp.server, seed=1))
        reset_launch_counts()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        out[backend] = [tbits(t) for t in tree_leaves(step.whole_state(state).params)]
        if backend is None:   # 12 leaves cut on 'model', 3 replicated: 24 slices a worker
            assert map_launch_counts()[mapped] == 24 * 4
        else:
            assert not any(launch_counts().values())
        assert float(metrics.get("nnz_dropped", 0.0)) == 0.0
    for a, b in zip(out[None], out["torch"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["psum", "allgather_packed"])
def test_tp_trainer_step_on_card_matches_plain_versions(cuda_device, impl):
    """One smoke-size step at M = 4 x T = 2 through the kernels and through
    the plain versions (backend='torch') on the card: the same parameters,
    bit for bit, and the counter-map kernels launched once a worker and
    message."""
    from repro_torch.launch.mesh import make_host_mesh
    model = Model(get_config("qwen1.5-4b", smoke=True))
    comp = CompressionConfig(compressor="sparsign",
                             budget=BudgetConfig(kind="l2_norm", value=0.1),
                             server="majority_vote")
    rng = np.random.RandomState(0)
    batch = {"inputs": rng.randint(0, 256, (4, 16)).astype(np.int32),
             "labels": rng.randint(0, 256, (4, 16)).astype(np.int32),
             "positions": np.broadcast_to(np.arange(16, dtype=np.int32), (4, 16)).copy()}
    out = {}
    for backend in (None, "torch"):
        step = build_train_step(model, TrainStepConfig(
            compression=comp, lr=LrSchedule(base=0.05), vote_impl=impl, backend=backend),
            make_host_mesh(4, 2))
        state = step.shard_state(init_state(model.init(0, device=cuda_device),
                                            server=comp.server, seed=1))
        reset_launch_counts()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        out[backend] = [tbits(t) for t in tree_leaves(step.whole_state(state).params)]
        if backend is None:   # 12 leaves cut on 'model', 3 replicated: 27 messages a worker
            encoder = "sparsign" if impl == "psum" else "sparsign_pack2bit"
            assert counts[encoder] == 27 * 4 and counts["vote_update"] == 27
        else:
            assert not any(counts.values())
    for a, b in zip(out[None], out["torch"]):
        np.testing.assert_array_equal(a, b)


def int8_rows(rows, n, dtype, device, seed, offset=0):
    """(rows, n) gradients with +-0, NaN, +-inf and subnormals in every row,
    starting ``offset`` elements into their storage (16-byte alignment
    lost for an odd offset)."""
    g = torch.from_numpy(grad_like(rows * n + offset, seed)).to(device)
    g[offset:offset + min(8, rows * n)] = torch.tensor(
        [float("nan"), float("inf"), -float("inf"), 1e-30, -3e-39, 0.0, -0.0, 2.0**-130],
        device=device)[:min(8, rows * n)]
    return g.to(dtype)[offset:].reshape(rows, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_encoders_at_tile_edges_and_row_starts_on_card(cuda_device, dtype):
    """Rows 1 and 4 (every rule, ``csrc/int8_encode.cuh``) against their
    plain versions, bit for bit: rows about a run (16), a tile (4,096 and
    8,192) and an FL row (545,002) long, many rows whose starts fall
    anywhere on a 16-byte line, a gradient off 16-byte alignment, n = 1,
    per-row seeds and params (NaN, 0, inf among them), and counter bases
    that wrap inside a row."""
    cases = [(1, 1, 0, 0), (7, 1, 3, 0), (1000, 5, 2**32 - 9, 0), (33, 17, 0, 1),
             (3, 4095, 2**32 - 7, 0), (2, 4096, 0, 0), (5, 4097, 17, 1), (9, 8191, 0, 0),
             (4, 8192, 2**32 - 5000, 0), (3, 8193, 5, 3), (3, 545002, 2**32 - 300000, 0),
             (2, 545002, 0, 1)]
    for rows, n, base, offset in cases:
        g = int8_rows(rows, n, dtype, cuda_device, rows + n, offset)
        seeds = torch.randint(0, 2**32, (rows,), device=cuda_device)
        prm = torch.rand(rows, device=cuda_device) * 3
        prm[:3] = torch.tensor([float("nan"), 0.0, float("inf")], device=cuda_device)[:rows]
        for p in (prm, torch.tensor([0.7], device=cuda_device)):
            assert torch.equal(sparsign_op(g, p, seeds, base), sparsign_ref(g, p, seeds, base)), (
                rows, n, base, offset)
            for rule in RULES:
                assert torch.equal(ternary_compress_op(g, p, seeds, base, rule=rule),
                                   ternary_compress_ref(g, p, seeds, base, rule=rule)), (
                    rule, rows, n, base, offset)


@pytest.mark.cuda
def test_int8_fast_paths_fall_back_on_near_ties_on_card(cuda_device):
    """Inputs built to sit in the fast paths' bands: stochastic_ternary's
    |g| / s at its own uniform, noisy_sign's g at -sigma n of its own noise
    (and a few ulps off): rows 4 and 5 equal their plain versions bit for
    bit, and the fallback ran (``ternary_fallbacks``)."""
    from repro_torch.core import prng
    from repro_torch.kernels.ternary.kernel import ternary_fallbacks
    m, seed = 1 << 18, 4242
    idx = torch.arange(m, device=cuda_device)
    s = torch.tensor(seed, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    wiggle = 1 + torch.randint(-3, 4, (m,), generator=gen, device=cuda_device).float() * 2.0**-23
    sign = torch.where(torch.rand(m, generator=gen, device=cuda_device) < 0.5, -1.0, 1.0)
    near = {"stochastic_ternary": (prng.uniform01(s, idx) * 0.37 * wiggle * sign, 0.37)}
    u1 = torch.clamp(prng.uniform01(prng.fold_seed(s, 1), idx), min=1e-12)
    u2 = prng.uniform01(prng.fold_seed(s, 2), idx)
    noise = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
        torch.tensor(2.0 * np.pi, device=cuda_device, dtype=torch.float32) * u2)
    near["noisy_sign"] = (-(0.3 * noise) * wiggle, 0.3)
    ternary_fallbacks(cuda_device)
    for rule, (g, prm) in near.items():
        assert torch.equal(ternary_compress_op(g, prm, seed, 0, rule=rule),
                           ternary_compress_ref(g, prm, seed, 0, rule=rule)), rule
        assert torch.equal(ternary_pack2bit_op(g, prm, seed, 0, rule=rule),
                           ternary_pack2bit_ref(g, prm, seed, 0, rule=rule)), rule
        assert ternary_fallbacks(cuda_device) > 0, rule
