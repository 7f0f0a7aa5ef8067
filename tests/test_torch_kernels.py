"""The port's kernel families against the JAX package, on the CPU.

Each family's plain PyTorch version (the CPU path, and the card's comparison
for the CUDA kernel) must equal the JAX oracle bit for bit, and the JAX
Pallas kernel in interpret mode at a few shapes, exactly as the JAX tests run
it. The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import common as jcommon
from repro.kernels.ef_server.ops import ef_server_op as j_ef_server_op
from repro.kernels.ef_server.ref import ef_scale as j_ef_scale
from repro.kernels.ef_server.ref import ef_server_ref as j_ef_server_ref
from repro.kernels.sparsign.ops import sparsign_op as j_sparsign_op
from repro.kernels.sparsign.ref import sparsign_ref as j_sparsign_ref
from repro.kernels.vote_update.ops import vote_update_op as j_vote_update_op
from repro.kernels.vote_update.ref import vote_update_ref as j_vote_update_ref
from repro_torch import kernels as tkernels
from repro_torch.kernels import common as tcommon
from repro_torch.kernels.ef_server.kernel import ef_server_cuda
from repro_torch.kernels.ef_server.ops import ef_server_op
from repro_torch.kernels.ef_server.ref import ef_scale, ef_server_ref
from repro_torch.kernels.sparsign.kernel import sparsign_cuda
from repro_torch.kernels.sparsign.ops import sparsign_op
from repro_torch.kernels.sparsign.ref import sparsign_ref
from repro_torch.kernels.ternary.kernel import ternary_cuda
from repro_torch.kernels.ternary.ops import ternary_compress_op
from repro_torch.kernels.vote_update.kernel import vote_update_cuda, weighted_vote_update_cuda
from repro_torch.kernels.vote_update.ops import vote_update_op, weighted_vote_update_op
from repro_torch.kernels.vote_update.ref import vote_update_ref

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def tbits(t: torch.Tensor) -> np.ndarray:
    """Bit pattern of a torch tensor (torch.equal treats -0.0 as +0.0)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    if t.dtype == torch.float32:
        return t.view(torch.int32).numpy()
    return t.numpy()


def jbits(x) -> np.ndarray:
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def both(x: np.ndarray, dtype: str):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def grad_like(n, seed):
    g = np.random.RandomState(seed).randn(n).astype(np.float32) * 0.4
    g[::97] = 0.0
    g[1::97] = -0.0
    return g


# ---------------------------------------------------------------- sparsign

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,counter_base,budget", [
    (1, 0, 1.0), (517, 0, 5.0), (3001, 2**32 - 700, 1.0), (4096, 12345, 0.25)])
def test_sparsign_ref_matches_jax_bitwise(dtype, n, counter_base, budget):
    tg, jg = both(grad_like(n, n), dtype)
    seed = 0xFFFFFFFF if n == 517 else 0xC0FFEE
    want = j_sparsign_ref(jg, budget, np.uint32(seed), np.uint32(counter_base))
    got = sparsign_ref(tg, budget, seed, counter_base)
    assert got.dtype == torch.int8 and got.shape == tg.shape
    np.testing.assert_array_equal(tbits(got), jbits(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sparsign_ref_matches_pallas_interpret(dtype):
    tg, jg = both(grad_like(1531, 3), dtype)
    want = j_sparsign_op(jg, 2.0, np.uint32(77), np.uint32(513), interpret=True)
    np.testing.assert_array_equal(tbits(sparsign_ref(tg, 2.0, 77, 513)), jbits(want))


def test_sparsign_rows_are_per_worker_streams():
    """A (workers, n) batch with one seed and budget per row equals each
    worker compressed alone by the JAX oracle (the port's form of vmap)."""
    seeds = [0, 1, 0xFFFFFFFF, 0x9E3779B9]
    budgets = np.array([0.5, 1.0, 3.0, 10.0], np.float32)
    g = np.stack([grad_like(777, s) for s in range(4)])
    got = sparsign_op(torch.from_numpy(g), torch.from_numpy(budgets), seeds, 99)
    for r in range(4):
        want = j_sparsign_ref(jnp.asarray(g[r]), budgets[r], np.uint32(seeds[r]), np.uint32(99))
        np.testing.assert_array_equal(tbits(got[r]), jbits(want))


def test_sparsign_special_values_match_jax():
    g = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-30, -1e30, 0.5] * 8, np.float32)
    for budget in (0.0, 1.0, np.inf):
        want = j_sparsign_ref(jnp.asarray(g), budget, np.uint32(5), np.uint32(0))
        np.testing.assert_array_equal(tbits(sparsign_ref(torch.from_numpy(g), budget, 5)),
                                      jbits(want))


# ---------------------------------------------------------------- vote_update

@pytest.mark.parametrize("wdtype", ["f32", "bf16"])
@pytest.mark.parametrize("vdtype", [np.int8, np.int32])
@pytest.mark.parametrize("quorum", [1, 3])
def test_vote_update_ref_matches_jax_bitwise(wdtype, vdtype, quorum):
    rng = np.random.RandomState(quorum)
    w = rng.randn(1031).astype(np.float32)
    w[::50] = -0.0
    v = rng.randint(-6, 7, size=1031).astype(vdtype)
    tw, jw = both(w, wdtype)
    want = j_vote_update_ref(jw, jnp.asarray(v), 0.0123, quorum)
    got = vote_update_ref(tw, torch.from_numpy(v), 0.0123, quorum)
    assert got.dtype == tw.dtype
    np.testing.assert_array_equal(tbits(got), jbits(want))


def test_vote_update_ref_matches_pallas_interpret():
    rng = np.random.RandomState(0)
    w = rng.randn(2000).astype(np.float32)
    v = rng.randint(-20, 21, size=2000).astype(np.int32)
    want = j_vote_update_op(jnp.asarray(w), jnp.asarray(v), 0.03, quorum=3, interpret=True)
    got = vote_update_op(torch.from_numpy(w), torch.from_numpy(v), 0.03, quorum=3)
    np.testing.assert_array_equal(tbits(got), jbits(want))


# ---------------------------------------------------------------- ef_server

def ef_inputs(n, seed):
    rng = np.random.RandomState(seed)
    d = rng.randn(n).astype(np.float32)
    e = (rng.randn(n) * 0.1).astype(np.float32)
    d[:4], e[:4] = [0.0, -0.0, -0.0, 0.0], [-0.0, -0.0, 0.0, 0.0]
    d[4], d[5], e[6] = np.nan, 1.0, -np.nan
    d[7], e[7] = 0.25, -0.25
    return d, e


@pytest.mark.parametrize("n", [8, 1003])
def test_ef_server_ref_matches_jax_given_scale(n):
    d, e = ef_inputs(n, n)
    scale = np.float32(0.731)
    jo, je = j_ef_server_ref(jnp.asarray(d), jnp.asarray(e), scale)
    to, te = ef_server_ref(torch.from_numpy(d), torch.from_numpy(e), torch.tensor(scale))
    np.testing.assert_array_equal(tbits(to), jbits(jo))
    np.testing.assert_array_equal(tbits(te), jbits(je))


def test_ef_server_matches_pallas_interpret_and_scale_is_close():
    d, e = ef_inputs(1500, 1)
    d[4] = e[6] = 0.5  # a finite L1 scale
    jscale = np.float32(j_ef_scale(jnp.asarray(d), jnp.asarray(e)))
    tscale = ef_scale(torch.from_numpy(d), torch.from_numpy(e))
    # the L1 sum runs in another order in XLA and in torch
    np.testing.assert_allclose(float(tscale), float(jscale), rtol=1e-6)
    jo, je = j_ef_server_op(jnp.asarray(d), jnp.asarray(e), jscale, interpret=True)
    to, te = ef_server_op(torch.from_numpy(d), torch.from_numpy(e), torch.tensor(jscale))
    np.testing.assert_array_equal(tbits(to), jbits(jo))
    np.testing.assert_array_equal(tbits(te), jbits(je))


# ---------------------------------------------------------------- plumbing

@pytest.mark.parametrize("n", [1, 511, 512, 16385, 545002])
def test_canonical_view_matches_jax(n):
    assert tcommon.canonical_rows(n) == jcommon.canonical_rows(n)
    rows = tcommon.canonical_rows(n)
    assert tcommon.block_rows_for(rows) == jcommon.block_rows_for(rows)
    if n < 20000:
        x = np.arange(n, dtype=np.float32)
        tv, tn = tcommon.to_2d(torch.from_numpy(x))
        jv, jn = jcommon.to_2d(jnp.asarray(x))
        assert tn == jn
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tcommon.from_2d(tv, tn, (n,)).numpy(), x)


def test_jnp_sign_semantics():
    x = np.array([-0.0, 0.0, np.nan, -3.0, 2.0], np.float32)
    np.testing.assert_array_equal(tbits(tcommon.jnp_sign(torch.from_numpy(x))),
                                  jbits(jnp.sign(jnp.asarray(x))))


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: no quiet plain fallback."""
    g = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        sparsign_cuda(g, torch.ones(1), torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        vote_update_cuda(g, torch.zeros(8, dtype=torch.int32), 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        ef_server_cuda(g, g, torch.ones(1))
    with pytest.raises(ValueError, match="CUDA"):
        ternary_cuda(g, torch.ones(1), torch.zeros(1, dtype=torch.int64), rule="noisy_sign")
    with pytest.raises(ValueError, match="CUDA"):
        weighted_vote_update_cuda(g, g, torch.ones(1), 0.1, 0.5)


def test_cpu_ops_take_plain_versions_and_count_no_launch():
    tkernels.reset_launch_counts()
    g = torch.from_numpy(grad_like(100, 0))
    sparsign_op(g, 1.0, 3)
    vote_update_op(g, torch.ones(100, dtype=torch.int8), 0.1)
    ef_server_op(g, g)
    ternary_compress_op(g, 0.5, 3, rule="noisy_sign")
    weighted_vote_update_op(g, g, 2.0, 0.1, q_frac=0.5)
    assert tkernels.launch_counts() == {"sparsign": 0, "vote_update": 0, "ef_server": 0,
                                        "ternary": 0, "weighted_vote_update": 0,
                                        "sparsign_pack2bit": 0, "ternary_pack2bit": 0,
                                        "unpack2bit_sum": 0, "unpack2bit_wsum": 0,
                                        "sparsign_golomb": 0, "golomb_pack": 0,
                                        "ungolomb_sum": 0, "ungolomb_wsum": 0,
                                        "pack2bit": 0, "unpack2bit": 0, "qsgd8_pack8": 0,
                                        "unpack8_sum": 0}
