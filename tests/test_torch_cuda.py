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
from repro_torch.core.compressors import tree_leaves
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ef_server.ops import ef_server_op
from repro_torch.kernels.ef_server.ref import ef_server_ref
from repro_torch.kernels.pack2bit.ops import unpack2bit_sum_op, unpack2bit_wsum_op
from repro_torch.kernels.pack2bit.ref import unpack2bit_sum_ref, unpack2bit_wsum_ref
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
