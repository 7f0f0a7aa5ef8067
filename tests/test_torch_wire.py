"""The port's 2-bit packed vote wire against the JAX package, on the CPU: the
plain pack / unpack / decode-sum versions, the fused compress -> pack ops,
``compress_leaf(wire=)`` for every pack2 row, the three vote wires'
exchanges, the byte ledger and ``make_vote_wire``'s validation. Bit for bit
throughout; noisy_sign by the flip bound of ``test_torch_ternary.py`` (its
Box-Muller noise goes through ``log``/``cos``, which XLA and torch round
differently on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core.algorithm import CompressionConfig as JConfig
from repro.core.budgets import BudgetConfig as JBudget
from repro.dist import collectives as jcoll
from repro.dist import compat as jcompat
from repro.kernels import common as jcommon
from repro.kernels.pack2bit import ref as jref
from repro.kernels.sparsign_pack2bit.ops import sparsign_pack2bit_op as j_sparsign_pack
from repro.kernels.ternary.ops import ternary_pack2bit_op as j_ternary_pack
from repro_torch import kernels as tkernels
from repro_torch.core import engine as tengine
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import SPECS, tree_leaves
from repro_torch.dist import collectives as tcoll
from repro_torch.kernels import common as tcommon
from repro_torch.kernels.pack2bit import ref as tref
from repro_torch.kernels.pack2bit.kernel import unpack2bit_sum_cuda, unpack2bit_wsum_cuda
from repro_torch.kernels.pack2bit.ops import unpack2bit_sum_op, unpack2bit_wsum_op
from repro_torch.kernels.sparsign_pack2bit.kernel import sparsign_pack2bit_cuda
from repro_torch.kernels.sparsign_pack2bit.ops import sparsign_pack2bit_op
from repro_torch.kernels.ternary.kernel import ternary_pack2bit_cuda
from repro_torch.kernels.ternary.ops import ternary_pack2bit_op
from repro_torch.launch.mesh import make_mesh

SPECIALS = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-30, -1e30, -0.0], np.float32)
NOISY_FLIP_RATE = 1e-5   # test_torch_ternary.py's bound: at most 1 symbol in 10^5
PACK2_ROWS = [name for name, spec in SPECS.items() if spec.wire_format == "pack2"]


def grad_like(n, seed, scale=0.4):
    g = np.random.RandomState(seed).randn(n).astype(np.float32) * scale
    g[::97] = 0.0
    g[1::97] = -0.0
    g[:8] = SPECIALS[:n]
    return g


def votes(n, seed):
    return np.random.RandomState(seed).randint(-1, 2, n).astype(np.int8)


def packed_messages(m, n, seed):
    """(m, rows, 128) packed messages of random votes, with code-3 bytes
    (which decode as 0) planted in the pad."""
    p = np.stack([np.asarray(jref.pack2bit_ref(jcommon.to_2d(jnp.asarray(votes(n, seed + i)))[0]))
                  for i in range(m)])
    p[:, -1, -4:] = 0xFF
    return p


def f32bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def decoded(packed, n):
    """The ternary symbols of a packed canonical message (JAX's decode)."""
    return np.asarray(jref.unpack2bit_ref(jnp.asarray(packed))).reshape(-1)[:n]


# ---------------------------------------------------------------- plain versions

@pytest.mark.parametrize("n", [63, 1000, 20001])
def test_pack_and_unpack_plain_versions_match_jax(n):
    v = votes(n, n)
    jview, _ = jcommon.to_2d(jnp.asarray(v))
    want = np.asarray(jref.pack2bit_ref(jview))
    tview, _ = tcommon.to_2d(torch.from_numpy(v))
    got = tref.pack2bit_ref(tview)
    assert got.dtype == torch.uint8 and got.shape == tcommon.packed_shape(n)
    np.testing.assert_array_equal(got.numpy(), want)
    noisy = packed_messages(1, n, n)[0]   # code-3 bytes decode as 0
    np.testing.assert_array_equal(tref.unpack2bit_ref(torch.from_numpy(noisy)).numpy(),
                                  np.asarray(jref.unpack2bit_ref(jnp.asarray(noisy))))
    np.testing.assert_array_equal(tref.unpack2bit_ref(got).numpy().reshape(-1)[:n], v)


@pytest.mark.parametrize("m", [1, 3, 4])
@pytest.mark.parametrize("n", [63, 1000, 20001])
def test_decode_sum_plain_versions_match_jax(m, n):
    """The int32 decode-sum and the weighted float32 decode-sum, with weights
    of 0 (a zero weight times a -1 vote is -0.0, which the +0.0 seed turns
    into +0.0), 1, fractions and a negative, bit for bit."""
    p = packed_messages(m, n, 7 * n + m)
    want = np.asarray(jref.unpack2bit_sum_ref(jnp.asarray(p)))
    got = tref.unpack2bit_sum_ref(torch.from_numpy(p))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(unpack2bit_sum_op(torch.from_numpy(p), n, (n,)).numpy(),
                                  want.reshape(-1)[:n])
    w = np.array([0.0, 0.3, 1.0, -1.7][:m], np.float32)
    jw = np.asarray(jref.unpack2bit_wsum_ref(jnp.asarray(p), jnp.asarray(w)))
    tw = tref.unpack2bit_wsum_ref(torch.from_numpy(p), torch.from_numpy(w))
    np.testing.assert_array_equal(f32bits(tw.numpy()), f32bits(jw))
    np.testing.assert_array_equal(
        f32bits(unpack2bit_wsum_op(torch.from_numpy(p), torch.from_numpy(w), n, (n,)).numpy()),
        f32bits(jw.reshape(-1)[:n]))
    if m == 1:   # a lone zero weight: every -1 vote gives +0.0, never -0.0
        assert not np.signbit(f32bits(jw).view(np.float32)).any()


def test_wire_wrappers_refuse_cpu_tensors_and_ops_count_no_launch():
    """A wrapper launches its kernel or raises; on the CPU the ops take the
    plain versions and count no launch."""
    g, one = torch.zeros(600), torch.ones(1)
    seed = torch.zeros(1, dtype=torch.int64)
    p = torch.zeros((2, 32, 128), dtype=torch.uint8)
    for call in (lambda: sparsign_pack2bit_cuda(g, one, seed),
                 lambda: ternary_pack2bit_cuda(g, one, seed, rule="sign"),
                 lambda: unpack2bit_sum_cuda(p),
                 lambda: unpack2bit_wsum_cuda(p, torch.ones(2))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    tkernels.reset_launch_counts()
    sparsign_pack2bit_op(g, 1.0, 3)
    ternary_pack2bit_op(g, 1.0, 3, rule="noisy_sign")
    unpack2bit_sum_op(p, 600, (600,))
    unpack2bit_wsum_op(p, torch.ones(2), 600, (600,))
    assert not any(tkernels.launch_counts().values())


# ------------------------------------------------------- fused compress -> pack

@pytest.mark.parametrize("rule", ["sparsign", "sign", "stochastic_ternary", "noisy_sign"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,counter_base", [((63,), 0), ((7, 333), 2**32 - 300),
                                                ((4099,), 12345)])
def test_fused_pack_plain_versions_match_jax_interpret(rule, dtype, shape, counter_base):
    """The plain fused ops against the Pallas kernels in interpret mode, with
    +-0 / NaN / +-inf inputs and the canonical pad (63 coordinates fill one
    row of 32): the pad bytes are zero for every rule, noisy_sign included."""
    g = grad_like(int(np.prod(shape)), len(shape) + counter_base % 7).reshape(shape)
    jg = jnp.asarray(g) if dtype == "f32" else jnp.asarray(g).astype(jnp.bfloat16)
    tg = torch.from_numpy(g) if dtype == "f32" else torch.from_numpy(g).to(torch.bfloat16)
    param, seed = np.float32(0.7), 0xFFFFFFF0
    if rule == "sparsign":
        want = j_sparsign_pack(jg, param, np.uint32(seed), np.uint32(counter_base), interpret=True)
        got = sparsign_pack2bit_op(tg, float(param), seed, counter_base)
    else:
        want = j_ternary_pack(jg, param, np.uint32(seed), np.uint32(counter_base), rule=rule,
                              interpret=True)
        got = ternary_pack2bit_op(tg, float(param), seed, counter_base, rule=rule)
    want = np.asarray(want)
    n = g.size
    assert got.dtype == torch.uint8 and got.shape == tcommon.packed_shape(n) == want.shape
    assert not decoded(got.numpy(), want.size * 4)[n:].any()   # the pad packs as 0
    if rule == "noisy_sign":
        flips = int((decoded(got.numpy(), n) != decoded(want, n)).sum())
        assert flips <= NOISY_FLIP_RATE * n + 1, flips
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", PACK2_ROWS)
def test_compress_leaf_wire_matches_jax(name):
    """``compress_leaf(wire=)`` for every pack2 row: the packed message and
    its decode scale against the JAX engine with its own packed wire (jnp
    backend). Norms are float sums in another order, so scales agree to rtol
    1e-6; the packed bytes bit for bit (noisy_sign by its flip bound)."""
    g = grad_like(3001, 5, scale=0.05)
    jwire = jcoll.PackedVoteWire(axes=("data",), n_workers=4)
    twire = tcoll.make_vote_wire("allgather_packed", make_mesh((4,), ("data",)))
    jc = JConfig(compressor=name, budget=JBudget(value=3.0))
    tc = CompressionConfig(compressor=name, budget=BudgetConfig(value=3.0))
    want = jengine.compress_leaf(jnp.asarray(g), jc, np.uint32(77), np.uint32(9),
                                 backend="jnp", wire=jwire)
    got = tengine.compress_leaf(torch.from_numpy(g), tc, 77, 9, wire=twire)
    assert got.values.dtype == torch.uint8 and got.values.shape == tcommon.packed_shape(g.size)
    np.testing.assert_allclose(float(got.scale), float(want.scale), rtol=1e-6)
    flips = int((decoded(got.values.numpy(), g.size) != decoded(want.values, g.size)).sum())
    assert flips <= (NOISY_FLIP_RATE * g.size + 1 if name == "noisy_sign" else 0), flips
    if name != "noisy_sign":
        np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    with pytest.raises(ValueError, match="one seed"):
        tengine.compress_leaf(torch.from_numpy(np.stack([g, g])), tc, torch.tensor([1, 2]),
                              wire=twire)


def test_identity_refuses_the_packed_wire():
    twire = tcoll.make_vote_wire("allgather_packed", make_mesh((2,), ("data",)))
    with pytest.raises(ValueError, match="ternary messages only"):
        tengine.compress_leaf(torch.ones(5), CompressionConfig(compressor="identity"), 1,
                              wire=twire)


def test_message_nnz_and_mask_match_jax():
    p = packed_messages(1, 5000, 3)[0]
    jwire = jcoll.PackedVoteWire(axes=("data",), n_workers=4)
    twire = tcoll.make_vote_wire("allgather_packed", make_mesh((4,), ("data",)))
    tp = torch.from_numpy(p)
    assert float(twire.message_nnz(tp)) == float(jwire.message_nnz(jnp.asarray(p)))
    for keep in (True, False):
        np.testing.assert_array_equal(
            twire.mask_message(tp, torch.tensor(keep)).numpy(),
            np.asarray(jwire.mask_message(jnp.asarray(p), jnp.bool_(keep))))
    v = votes(777, 4)
    iwire = tcoll.make_vote_wire("psum", make_mesh((4,), ("data",)))
    jiwire = jcoll.VoteWire(axes=("data",), n_workers=4)
    assert float(iwire.message_nnz(torch.from_numpy(v))) == float(
        jiwire.message_nnz(jnp.asarray(v)))


# ------------------------------------------------------------------ the wires

WEIGHTS = np.array([1.5, 0.0, 2.0, 0.25], np.float32)


def _wires(participation=None):
    flat = make_mesh((4,), ("data",))
    hier = make_mesh((2, 2), ("pod", "data"))
    return {"psum": tcoll.make_vote_wire("psum", flat, participation=participation),
            "hier": tcoll.make_vote_wire("hier", hier, participation=participation),
            "allgather_packed": tcoll.make_vote_wire("allgather_packed", flat,
                                                     participation=participation)}


@pytest.mark.parametrize("n,shape", [(1000, (1000,)), (3 * 777, (3, 777))])
def test_wire_exchanges_match_the_jax_decode(n, shape):
    """A local M = 4 stack through each wire: the vote totals (int8) and the
    weighted sums equal JAX's decode of the same stacked packed messages."""
    p = packed_messages(4, n, n)
    jp = jnp.asarray(p)
    want = np.asarray(jcoll._packed_decode_sum(jp, n, shape, backend="jnp")).astype(np.int8)
    wwant = np.asarray(jcoll._packed_decode_wsum(jp, jnp.asarray(WEIGHTS), n, shape,
                                                 backend="jnp"))
    int8 = torch.from_numpy(np.stack([decoded(p[i], n).reshape(shape) for i in range(4)]))
    spec = tcoll.ParticipationSpec()   # the effective weights below include a dropped worker's 0
    for name, wire in _wires().items():
        msgs = torch.from_numpy(p) if wire.native_format == "pack2" else int8
        got = wire.exchange(msgs, n, shape)
        assert got.dtype == torch.int8 and tuple(got.shape) == shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        with pytest.raises(ValueError, match="ParticipationSpec"):
            wire.exchange_weighted(msgs, n, shape, weight=torch.from_numpy(WEIGHTS))
        with pytest.raises(ValueError, match="pack8"):
            wire.exchange(msgs, n, shape, scale=1.0)
    for name, wire in _wires(spec).items():
        msgs = torch.from_numpy(p) if wire.native_format == "pack2" else int8
        wv, wtot = wire.exchange_weighted(msgs, n, shape, weight=torch.from_numpy(WEIGHTS))
        np.testing.assert_array_equal(f32bits(wv.numpy()), f32bits(wwant), err_msg=name)
        np.testing.assert_array_equal(np.broadcast_to(wtot.numpy(), shape if wtot.dim() else ()),
                                      np.float32(WEIGHTS.sum()), err_msg=name)


@pytest.mark.parametrize("m", [1, 2, 4, 8])
@pytest.mark.parametrize("elastic", [False, True])
def test_uplink_ledger_and_gather_hbm_match_jax(m, elastic):
    part = tcoll.ParticipationSpec(dropout=0.25) if elastic else None
    jpart = jcoll.ParticipationSpec(dropout=0.25) if elastic else None
    twires = {"psum": tcoll.make_vote_wire("psum", make_mesh((m,), ("data",)), participation=part),
              "allgather_packed": tcoll.make_vote_wire("allgather_packed",
                                                       make_mesh((m,), ("data",)),
                                                       participation=part)}
    jwires = {"psum": jcoll.VoteWire(axes=("data",), n_workers=m, participation=jpart),
              "allgather_packed": jcoll.PackedVoteWire(axes=("data",), n_workers=m,
                                                       participation=jpart)}
    if m % 2 == 0:
        twires["hier"] = tcoll.make_vote_wire("hier", make_mesh((2, m // 2), ("pod", "data")),
                                              participation=part)
        jwires["hier"] = jcoll.HierVoteWire(axes=("pod", "data"), n_workers=m,
                                            inner_size=m // 2, outer_size=2, participation=jpart)
    for impl, tw in twires.items():
        jw = jwires[impl]
        for n in (1, 511, 512 * 32 + 1, 707_788_800):
            for mode in ("votes", "scaled_votes", "decoded"):
                for share in (False, True):
                    assert tcoll.uplink_ledger(mode, tw, n, share_linf=share) == \
                        jcoll.uplink_ledger(mode, jw, n, share_linf=share), (impl, n, mode)
            assert tw.gather_hbm_bytes(n) == jw.gather_hbm_bytes(n), (impl, n)
            assert tw.wire_bytes(n) == jw.wire_bytes(n), (impl, n)


def _jax_error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e)
    return None


def test_make_vote_wire_validation_matches_jax():
    jflat = jcompat.make_mesh((1, 1), ("data", "model"))
    jhier = jcompat.make_mesh((1, 1), ("pod", "data"))
    flat, hier = make_mesh((1,), ("data",)), make_mesh((1, 1), ("pod", "data"))
    cases = [
        ("unknown impl", ("ring",), {}, False),
        ("hier on one axis", ("hier",), {}, False),
        ("unknown format", ("psum",), {"wire_format": "pack4"}, False),
        ("pack8 on psum", ("psum",), {"wire_format": "pack8"}, False),
        ("golomb on hier", ("hier",), {"wire_format": "golomb", "golomb_p": 0.1}, True),
        ("golomb without p", ("allgather_packed",), {"wire_format": "golomb"}, False),
        ("golomb p of 1", ("allgather_packed",), {"wire_format": "golomb", "golomb_p": 1.0},
         False),
        ("ring on psum", ("psum",), {"ring_chunk_rows": 32}, False),
        ("ring of 33 rows", ("allgather_packed",), {"ring_chunk_rows": 33}, False),
        ("participation of a dict", ("psum",), {"participation": {"weights": (1.0,)}}, False),
        ("weights for 2 of 1", ("psum",), {"participation": "two"}, False),
    ]
    for label, args, kw, on_hier in cases:
        jkw, tkw = dict(kw), dict(kw)
        if kw.get("participation") == "two":
            jkw["participation"] = jcoll.ParticipationSpec(weights=(1.0, 1.0))
            tkw["participation"] = tcoll.ParticipationSpec(weights=(1.0, 1.0))
        jaxes = ("pod", "data") if on_hier else ("data",)
        jerr = _jax_error(lambda: jcoll.make_vote_wire(*args, jaxes, jhier if on_hier else jflat,
                                                       **jkw))
        assert jerr is not None, label
        with pytest.raises(jerr):
            tcoll.make_vote_wire(*args, hier if on_hier else flat, **tkw)
    # valid arguments build the wire: the ring, the golomb and the pack8
    # wires are ported
    ring = tcoll.make_vote_wire("allgather_packed", flat, ring_chunk_rows=64)
    assert isinstance(ring, tcoll.PackedVoteWire) and ring.ring_chunk_rows == 64
    wire = tcoll.make_vote_wire("allgather_packed", flat, wire_format="golomb", golomb_p=0.05)
    assert isinstance(wire, tcoll.GolombWire) and wire.p == 0.05
    assert isinstance(tcoll.make_vote_wire("allgather_packed", flat, wire_format="pack8"),
                      tcoll.Pack8Wire)


@pytest.mark.parametrize("name", list(SPECS))
def test_wire_negotiation_matches_jax(name):
    """wire_mode and wire_payload_format for every ported row, server and
    vote impl, as the JAX engine answers them."""
    for server in ("majority_vote", "scaled_sign_ef", "mean"):
        for impl in tcoll.VOTE_IMPLS:
            jc, tc = JConfig(compressor=name, server=server), CompressionConfig(
                compressor=name, server=server)
            mode = jengine.wire_mode(jc, vote_impl=impl)
            assert tengine.wire_mode(tc, vote_impl=impl) == mode, (server, impl)
            assert tengine.wire_payload_format(tc, mode, vote_impl=impl) == \
                jengine.wire_payload_format(jc, mode, vote_impl=impl), (server, impl)


def test_broadcast_quorum_matches_jax():
    like = {"blocks": ({"a": 0, "b": 0},), "embed": 0, "final_norm": 0}
    for quorum in (1, 3, {"blocks": 2, "embed": 5, "final_norm": 1},
                   {"blocks": ({"a": 2, "b": 4},), "embed": 1, "final_norm": 7}):
        want = jax.tree_util.tree_leaves(jengine.broadcast_quorum(quorum, like))
        assert tree_leaves(tengine.broadcast_quorum(quorum, like)) == want
    for bad in (0, True, 1.5, {"blocks": 1}, {"blocks": (1, 2), "embed": 1, "final_norm": 1}):
        with pytest.raises(ValueError):
            jengine.broadcast_quorum(bad, like)
        with pytest.raises(ValueError):
            tengine.broadcast_quorum(bad, like)
