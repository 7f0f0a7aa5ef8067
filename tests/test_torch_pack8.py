"""The port's 8-bit QSGD (pack8) wire against the JAX package, on the CPU: the
plain level rule and its canonical view (against JAX's reference and its
Pallas kernel in interpret mode, at an injected decode scale), the decode
scale, the worker-order decode-sum, the wire negotiation, ``Pack8Wire``'s
exchanges and ledger, ``compress_leaf`` onto the wire, and an M = 4 trainer
step with injected gradients on the pack8 wire and on the decoded psum
against a per-worker JAX oracle. Everything integer or exactly rounded is
held bit for bit; the decode scale's L2 norm sums in another order than
XLA's and is held to rtol 1e-6. The kernels themselves are held against
these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jcomp
from repro.core import engine as jengine
from repro.core import prng as jprng
from repro.core.algorithm import CompressionConfig as JConfig
from repro.dist import collectives as jcoll
from repro.kernels import common as jcommon
from repro.kernels.pack8 import ref as jref
from repro.kernels.pack8.ops import qsgd8_pack8_op as j_pack8_op
from repro.kernels.pack8.ops import unpack8_sum_op as j_unpack8_op
from repro.train import sampling as jsampling
from repro_torch import kernels as tkernels
from repro_torch.core import compressors as tcomp
from repro_torch.core import engine as tengine
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.compressors import tree_leaves
from repro_torch.dist import collectives as tcoll
from repro_torch.kernels.common import canonical_rows
from repro_torch.kernels.pack8 import ref as tref
from repro_torch.kernels.pack8.kernel import qsgd8_pack8_cuda, unpack8_sum_cuda
from repro_torch.kernels.pack8.ops import qsgd8_op, qsgd8_pack8_op, unpack8_sum_op
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import params_from_numpy
from repro_torch.train.state import LrSchedule, init_state
from repro_torch.train.step_simple import TrainStepConfig, build_train_step
from test_torch_train import SHAPES, M, InjectedModel

SPECIALS = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-30, -1e30, -0.0], np.float32)
SCALE_RTOL = 1e-6   # the L2 norm: torch and XLA sum the squares in other orders


def grad_like(n, seed, scale=0.4):
    g = np.random.RandomState(seed).randn(n).astype(np.float32) * scale
    g[::97] = 0.0
    g[1::97] = -0.0
    g[:8] = SPECIALS[:n]
    return g


def f32bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def bf16(x):
    """float32 numpy -> (the JAX bfloat16 array, the torch bfloat16 tensor)."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j).view(np.int16).copy()).view(torch.bfloat16)


def levels_like(m, n, seed):
    """(m, rows, 512) canonical int8 views of random levels in [-127, 127]."""
    rng = np.random.RandomState(seed)
    out = np.zeros((m, canonical_rows(n) * 512), np.int8)
    out[:, :n] = rng.randint(-127, 128, (m, n))
    return out.reshape(m, -1, 512)


# ---------------------------------------------------------------- the level rule

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,cb", [(1, 0), (2331, 2**32 - 1000), (65536, 17)])
def test_levels_match_jax_at_an_injected_scale(n, cb, dtype):
    """The level rule at a given decode scale, the wrap of the counter past
    2^32 included, and its canonical view: the bytes of JAX's reference.
    A scale of 1/40 of the largest entry exercises every level up to the
    clip at 127 (1e30 and inf clip, NaN quantizes to 0); a NaN scale (the L2
    norm of a gradient holding a NaN) quantizes everything to 0."""
    g = grad_like(n, n)
    if dtype == "float32":
        jg, tg = jnp.asarray(g), torch.from_numpy(g)
    else:
        jg, tg = bf16(g)
    for param in (np.float32(0.4 / 40), np.float32(3.7e-3), np.float32(0.0), np.float32(np.nan)):
        want = np.asarray(jref.qsgd8_levels_ref(jg, param, 12345, cb))
        got = tref.qsgd8_levels_ref(tg, torch.tensor(param), 12345, cb)
        assert got.dtype == torch.int8 and tuple(got.shape) == (n,)
        np.testing.assert_array_equal(got.numpy(), want)
        view = tref.qsgd8_pack8_ref(tg, float(param), 12345, cb)
        assert tuple(view.shape) == (canonical_rows(n), 512)
        np.testing.assert_array_equal(view.numpy(),
                                      np.asarray(jref.qsgd8_pack8_ref(jg, param, 12345, cb)))
        np.testing.assert_array_equal(qsgd8_op(tg, float(param), 12345, cb).numpy(), want)
    assert np.abs(want).max() <= 127


@pytest.mark.parametrize("n", [63, 4099])
def test_pack8_op_matches_the_pallas_kernel_in_interpret_mode(n):
    """The fused op's plain version against JAX's qsgd8_pack8 kernel run in
    interpret mode, f32 and bf16, at a counter base near 2^32."""
    g = grad_like(n, 3 * n)
    scale = np.float32(np.abs(g[np.isfinite(g)]).max() / 50)
    for jg, tg in ((jnp.asarray(g), torch.from_numpy(g)), bf16(g)):
        want = np.asarray(j_pack8_op(jg, scale, 99, np.uint32(2**32 - 5000), interpret=True))
        got = qsgd8_pack8_op(tg, float(scale), 99, 2**32 - 5000)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 5000, 65536])
def test_qsgd8_scale_and_compressor_match_jax(n):
    """max(||g||_2, 1e-12) / 127 to rtol 1e-6 (the order of the squares'
    sum), the 1e-12 floor for a zero gradient exactly; the public compressor
    returns the levels at its own scale."""
    g = np.random.RandomState(n).randn(n).astype(np.float32)
    want = float(jcomp.qsgd8_scale(jnp.asarray(g)))
    got = tcomp.qsgd8_scale(torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=SCALE_RTOL)
    zero = np.zeros(n, np.float32)
    assert f32bits(tcomp.qsgd8_scale(torch.from_numpy(zero))) == f32bits(
        jcomp.qsgd8_scale(jnp.asarray(zero)))
    msg = tcomp.qsgd8(torch.from_numpy(g), seed=5, counter_base=3)
    np.testing.assert_array_equal(
        msg.values.numpy(), np.asarray(jref.qsgd8_levels_ref(jnp.asarray(g), msg.scale.numpy(),
                                                             5, 3)))


# ---------------------------------------------------------------- the decode-sum

@pytest.mark.parametrize("m", [1, 3, 8])
def test_decode_sum_matches_jax(m):
    """sum_m scale_m * levels_m from +0.0 in worker order against JAX's eager
    reference, bit for bit: zero scales (a zero scale times a negative level
    is -0.0, which the +0.0 seed turns into +0.0) and fractional ones. JAX's
    Pallas kernel in interpret mode runs under jit, where XLA folds the +0.0
    seed away and a sum of -0.0 products stays -0.0: it equals the port in
    value everywhere and in bits wherever the sum is not zero."""
    n = 4099
    lv = levels_like(m, n, m)
    scales = np.array([0.0, 1.3e-3, 0.25, 0.0, 7.0, 1e-30, 3.5, 0.9][:m], np.float32)
    want = np.asarray(jref.unpack8_sum_ref(jnp.asarray(lv), jnp.asarray(scales)))
    got = tref.unpack8_sum_ref(torch.from_numpy(lv), torch.from_numpy(scales))
    assert got.dtype == torch.float32 and tuple(got.shape) == lv.shape[1:]
    np.testing.assert_array_equal(f32bits(got.numpy()), f32bits(want))
    kern = np.asarray(j_unpack8_op(jnp.asarray(lv), jnp.asarray(scales), n, (n,),
                                   interpret=True))
    op = unpack8_sum_op(torch.from_numpy(lv), torch.from_numpy(scales), n, (n,))
    np.testing.assert_array_equal(op.numpy(), kern)
    nonzero = kern != 0
    np.testing.assert_array_equal(f32bits(op.numpy())[nonzero], f32bits(kern)[nonzero])
    np.testing.assert_array_equal(f32bits(op.numpy()), f32bits(want.reshape(-1)[:n]))
    if m == 1:   # a lone zero scale: every negative level gives +0.0
        assert not np.signbit(got.numpy()).any()


def test_pack8_wrappers_refuse_cpu_tensors_and_ops_count_no_launch():
    g, one = torch.zeros(600), torch.ones(1)
    seed = torch.zeros(1, dtype=torch.int64)
    tkernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        qsgd8_pack8_cuda(g, one, seed)
    with pytest.raises(ValueError, match="CUDA"):
        unpack8_sum_cuda(torch.zeros((1, 32, 512), dtype=torch.int8), one)
    qsgd8_pack8_op(g, 0.1, 3)
    unpack8_sum_op(torch.zeros((2, 32, 512), dtype=torch.int8), torch.ones(2), 600, (600,))
    assert tkernels.launch_counts()["qsgd8_pack8"] == 0
    assert tkernels.launch_counts()["unpack8_sum"] == 0


# ---------------------------------------------------------------- the wire

@pytest.mark.parametrize("server", ["majority_vote", "scaled_sign_ef", "mean"])
def test_wire_mode_and_payload_format_match_jax(server):
    """qsgd8 rides the pack8 wire on allgather_packed and the decoded psum on
    the psum and hier impls, as the JAX engine answers."""
    jc, tc = JConfig(compressor="qsgd8", server=server), CompressionConfig(compressor="qsgd8",
                                                                           server=server)
    for impl in tcoll.VOTE_IMPLS + (None,):
        mode = jengine.wire_mode(jc, vote_impl=impl)
        assert tengine.wire_mode(tc, vote_impl=impl) == mode
        assert mode == ("pack8" if impl == "allgather_packed" else "decoded")
        assert (tengine.wire_payload_format(tc, mode, vote_impl=impl)
                == jengine.wire_payload_format(jc, mode, vote_impl=impl))
    assert tcomp.get_spec("qsgd8").wire_format == "pack8"


def test_pack8_wire_exchanges_match_the_jax_oracle():
    """Pack8Wire.exchange: the decoded sum of the gathered levels with each
    worker's scale; exchange_weighted: the weight premultiplies the scale
    ([scale * w, w]) and W is the weights' sum. Bit for bit JAX's eager
    reference sum over the same messages; the plain-version backend agrees."""
    n, shape = 3001, (3001,)
    lv = levels_like(M, n, 11)
    scales = np.array([1e-3, 2.5e-2, 0.0, 0.4], np.float32)
    weights = np.array([1.5, 0.0, 2.0, 0.5], np.float32)
    group = make_mesh((M,), ("data",))
    part = tcoll.ParticipationSpec(weights=(1.5, 0.5, 2.0, 1.0))
    want = np.asarray(jref.unpack8_sum_ref(jnp.asarray(lv), jnp.asarray(scales))).reshape(-1)[:n]
    wwant = np.asarray(jref.unpack8_sum_ref(jnp.asarray(lv), jnp.asarray(scales * weights))
                       ).reshape(-1)[:n]
    for backend in (None, "torch"):
        wire = tcoll.make_vote_wire("allgather_packed", group, wire_format="pack8",
                                    backend=backend)
        assert isinstance(wire, tcoll.Pack8Wire) and wire.native_format == "pack8"
        got = wire.exchange(torch.from_numpy(lv), n, shape, scale=torch.from_numpy(scales))
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(f32bits(got.numpy()), f32bits(want))
        with pytest.raises(ValueError, match="decode scale"):
            wire.exchange(torch.from_numpy(lv), n, shape)
        with pytest.raises(ValueError, match="ParticipationSpec"):
            wire.exchange_weighted(torch.from_numpy(lv), n, shape,
                                   weight=torch.from_numpy(weights),
                                   scale=torch.from_numpy(scales))
        ewire = tcoll.make_vote_wire("allgather_packed", group, wire_format="pack8",
                                     backend=backend, participation=part)
        wv, wtot = ewire.exchange_weighted(torch.from_numpy(lv), n, shape,
                                           weight=torch.from_numpy(weights),
                                           scale=torch.from_numpy(scales))
        np.testing.assert_array_equal(f32bits(wv.numpy()), f32bits(wwant))
        assert float(wtot) == float(weights.sum())
    assert float(wire.message_nnz(torch.from_numpy(lv[0]))) == float((lv[0] != 0).sum())


@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("elastic", [False, True])
def test_pack8_ledger_matches_jax(m, elastic):
    """uplink_ledger('pack8', ...) with the per-worker scales (8 B under
    elastic participation), wire, scalar and gather bytes, at JAX's shapes."""
    part = tcoll.ParticipationSpec(dropout=0.25) if elastic else None
    jpart = jcoll.ParticipationSpec(dropout=0.25) if elastic else None
    tw = tcoll.make_vote_wire("allgather_packed", make_mesh((m,), ("data",)),
                              wire_format="pack8", participation=part)
    jw = jcoll.Pack8Wire(axes=("data",), n_workers=m, participation=jpart)
    for n in (1, 511, 512 * 32 + 1, 707_788_800):
        assert tcoll.uplink_ledger("pack8", tw, n) == jcoll.uplink_ledger("pack8", jw, n), n
        assert tcoll.uplink_ledger("decoded", tw, n) == jcoll.uplink_ledger("decoded", jw, n)
        assert tw.wire_bytes(n) == jw.wire_bytes(n)
        assert tw.gather_hbm_bytes(n) == jw.gather_hbm_bytes(n)
        assert tcoll.packed8_nbytes(n) == jcoll.packed8_nbytes(n)
    assert tw.scalar_bytes() == jw.scalar_bytes()
    for impl in ("psum", "allgather_packed"):
        plain = tcoll.make_vote_wire(impl, make_mesh((m,), ("data",)))
        jplain = (jcoll.VoteWire if impl == "psum" else jcoll.PackedVoteWire)(
            axes=("data",), n_workers=m)
        assert plain.scalar_bytes() == jplain.scalar_bytes()


def test_compress_leaf_onto_the_pack8_wire_matches_jax():
    """engine.compress_leaf into the int8 level view (the plain versions)
    against JAX's jnp backend, at a gradient whose L2 norm both sides sum
    exactly (multiples of 1/8), so the scales agree bit for bit; the pack2
    wire refuses the pack8 row and the pack8 wire a ternary one."""
    n = 4099
    g = np.random.RandomState(2).randint(-16, 17, n).astype(np.float32) / 8
    jc, tc = JConfig(compressor="qsgd8", server="mean"), CompressionConfig(compressor="qsgd8",
                                                                           server="mean")
    jw = jcoll.Pack8Wire(axes=("data",), n_workers=4)
    tw = tcoll.make_vote_wire("allgather_packed", make_mesh((4,), ("data",)),
                              wire_format="pack8")
    want = jengine.compress_leaf(jnp.asarray(g), jc, 77, 5, backend="jnp", wire=jw)
    got = tengine.compress_leaf(torch.from_numpy(g), tc, 77, 5, wire=tw)
    assert f32bits(got.scale) == f32bits(want.scale)
    assert got.values.dtype == torch.int8 and tuple(got.values.shape) == (canonical_rows(n), 512)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    packed = tcoll.make_vote_wire("allgather_packed", make_mesh((4,), ("data",)))
    with pytest.raises(ValueError, match="declares wire format 'pack8'"):
        tengine.compress_leaf(torch.from_numpy(g), tc, 77, wire=packed)
    with pytest.raises(ValueError, match="int8 sign\\*level"):
        tengine.compress_leaf(torch.from_numpy(g), CompressionConfig(), 77, wire=tw)


# ------------------------------------------------------ the trainer, M = 4

def _exact_injected(seed):
    """Parameters and per-worker gradients of test_torch_train's injected
    model, the gradients multiples of 1/8 in [-2, 2] (zero every 53rd), so
    every L2 norm is the same float in any order of sums."""
    rng = np.random.RandomState(seed)
    shapes = [s.shape for s in tree_leaves(SHAPES)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    per = []
    for s in shapes:
        g = rng.randint(-16, 17, (M,) + s).astype(np.float32) / 8
        g.reshape(M, -1)[:, ::53] = 0.0
        per.append(g)
    return params, per, {f"g{i}": g for i, g in enumerate(per)}


def qsgd8_oracle(params, per, *, seed, step, lr, part=None):
    """One round of the trainer worker by worker from the JAX package's
    parts: sampling and seeds, the engine's compress_leaf (jnp backend), the
    decoded messages (scale times the effective weight under participation)
    summed in worker order, and the mean server."""
    jc = JConfig(compressor="qsgd8", server="mean")
    rseed = jsampling.round_seed(jnp.uint32(seed), jnp.int32(step))
    wseeds = [jprng.fold_seed(rseed, 0x5EED) + jnp.uint32(w) * jnp.uint32(0x9E3779B9)
              for w in range(M)]
    mask = [jsampling.participation_mask(rseed, jnp.int32(step), jnp.uint32(w), 1.0)
            for w in range(M)]
    w_eff = [jnp.float32(1.0)] * M
    if part is not None:
        mask = [mk & jsampling.report_mask(rseed, jnp.int32(step), jnp.uint32(w), part.dropout)
                for w, mk in enumerate(mask)]
        w_eff = [jnp.float32(part.weights[w]) * jnp.asarray(mask[w], jnp.float32)
                 for w in range(M)]
    n_sel = (sum(jnp.asarray(mk, jnp.float32) for mk in mask) if part is None
             else sum(w_eff[1:], w_eff[0]))
    out = []
    for i, p in enumerate(params):
        total = None
        for w in range(M):
            msg = jengine.compress_leaf(jnp.asarray(per[i][w]), jc,
                                        jprng.fold_seed(wseeds[w], i), backend="jnp")
            scale = msg.scale * w_eff[w] if part is not None else msg.scale
            dec = jnp.where(mask[w], msg.values.astype(jnp.float32) * scale, 0.0)
            total = dec if total is None else total + dec
        new, _ = jengine.server_apply(jnp.asarray(p), total, jc, lr=lr, n_sel=n_sel,
                                      server="mean", backend="jnp")
        out.append(np.asarray(new))
    return out


@pytest.mark.parametrize("elastic", [False, True])
def test_m4_qsgd8_step_pack8_equals_decoded_psum_and_the_jax_oracle(elastic):
    """Two rounds at M = 4 with injected gradients: qsgd8 with the mean
    server on the pack8 wire (allgather_packed) and on the decoded psum give
    bitwise-equal parameters, and both equal the per-worker JAX oracle; the
    wire bytes are the ledger's. Elastic: weights 1.5, 0.5, 2, 1 and dropout
    0.25."""
    weights = (1.5, 0.5, 2.0, 1.0)
    tpart = tcoll.ParticipationSpec(weights=weights, dropout=0.25) if elastic else None
    jpart = jcoll.ParticipationSpec(weights=weights, dropout=0.25) if elastic else None
    comp = CompressionConfig(compressor="qsgd8", server="mean")
    steps = {impl: build_train_step(InjectedModel(), TrainStepConfig(
        compression=comp, lr=LrSchedule(base=0.05), vote_impl=impl, participation=tpart),
        make_mesh((M,), ("data",))) for impl in ("allgather_packed", "psum")}
    assert steps["allgather_packed"].mode == "pack8"
    assert isinstance(steps["allgather_packed"].wire, tcoll.Pack8Wire)
    assert steps["psum"].mode == "decoded"
    params, _, _ = _exact_injected(0)

    def state_of(leaves):
        return init_state(params_from_numpy({"blocks": ({"a": leaves[0], "b": leaves[1]},),
                                             "embed": leaves[2], "final_norm": leaves[3]}),
                          server="mean", seed=11)

    states = {impl: state_of(params) for impl in steps}
    for r in range(2):
        _, per, batch = _exact_injected(r + 1)
        want = qsgd8_oracle(params, per, seed=11, step=r, lr=np.float32(0.05), part=jpart)
        got = {}
        for impl, step in steps.items():
            states[impl], metrics = step(states[impl], batch)
            got[impl] = [t.numpy().copy() for t in tree_leaves(states[impl].params)]
            ledger = sum(tcoll.uplink_ledger(step.mode, step.wire, int(np.prod(s.shape)))
                         for s in tree_leaves(SHAPES))
            assert float(metrics["wire_bytes_per_device"]) == np.float32(ledger)
            assert float(metrics["nnz_frac"]) > 0.0
        for a, b, c in zip(got["allgather_packed"], got["psum"], want):
            np.testing.assert_array_equal(f32bits(a), f32bits(b))
            np.testing.assert_array_equal(f32bits(a), f32bits(c))
        assert any((a != p).any() for a, p in zip(got["allgather_packed"], params))
        params = got["allgather_packed"]
