"""The port's serving path against the JAX package, on the CPU, at the
qwen1.5-4b smoke size (float32) from the JAX model's parameters: prefill
(logits and caches) and decode into a replayed max_len cache, the
prompt-deep cache that JAX's prefill returns and the slot its first decode
overwrites, the weight-update encoders' bytes, the three ingest wires, their
refusals, and the launcher on the CPU.

Logits and the caches' K and V are held to REL_TOL of their largest
magnitude: both sides compute the same float32 graph, but XLA's matmuls,
reductions and transcendentals round in other orders than torch's; the gap
grows through the layers, to 7.4e-6 of the largest final hidden value after
the two smoke layers when measured (first layer's K 2.6e-7), so REL_TOL
leaves a margin of about 2.7x. Position slots, bytes and ingested parameters
are held bit for bit; the packed8 ingest against JAX's jitted step to two
ulps of |p| + |p'|, because XLA on the CPU contracts ``p - lr * scale *
levels`` into a fused multiply-add where torch rounds the product first, and
bit for bit against the same step run eagerly (``disable_jit``).
The kernels of the path (pack2bit, unpack2bit, qsgd8_pack8, vote_update) are
held against these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.kernels.pack2bit.ops import pack2bit_op as j_pack_op
from repro.kernels.pack2bit.ops import unpack2bit_op as j_unpack_op
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models.model import Model as JModel
from repro.serve import decode as jserve
from repro_torch import kernels as tkernels
from repro_torch.configs.registry import get_config
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.kernels.common import packed_shape
from repro_torch.kernels.pack2bit.kernel import pack2bit_cuda, unpack2bit_cuda
from repro_torch.kernels.pack2bit.ops import pack2bit_op, unpack2bit_op
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as tattention
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel
from repro_torch.models import rope as trope
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.serve import decode as tserve

REL_TOL = 2e-5   # of the largest magnitude: float32 sums in XLA's order against torch's
B, S, NEW = 2, 24, 6   # the prompt crosses the attention chunk (16)


@pytest.fixture(scope="module")
def models():
    jm = JModel(jget_config("qwen1.5-4b", smoke=True))
    tm = Model(get_config("qwen1.5-4b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    # the smoke init zeroes the norms and biases: give them values, so the
    # comparison exercises them
    rng = np.random.RandomState(7)
    jp = jax.tree_util.tree_map(
        lambda x: x if np.asarray(x).any() else jnp.asarray(rng.randn(*x.shape) * 0.1, x.dtype),
        jp)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jm, tm, jp, tp, j_host_mesh(1, 1)


def _prompt(s=S, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 256, (B, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy()
    return toks, pos


def _close(got, want):
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= REL_TOL * float(np.abs(want).max()), err


def _jax_layer(caches, i):
    """Layer i's cache of JAX's stacked {"body": ({k: (R, ...)},)} tree."""
    return {k: np.asarray(v[i]) for k, v in caches["body"][0].items()}


def test_prefill_and_replayed_decode_match_jax(models):
    """build_prefill's last-position logits and prompt-deep caches; then the
    launcher's loop, the prompt replayed through decode into an empty
    max_len cache and greedy tokens after it: every step's logits, and the
    final caches bit for bit in their positions, to LOGIT_RTOL in K and V."""
    jm, tm, jp, tp, mesh = models
    toks, pos = _prompt()
    jlogits, jcaches = jserve.build_prefill(jm, mesh)(
        jp, {"inputs": jnp.asarray(toks), "positions": jnp.asarray(pos)})
    tlogits, tcaches = tserve.build_prefill(tm)(
        tp, {"inputs": torch.from_numpy(toks), "positions": torch.from_numpy(pos)})
    assert tlogits.dtype == torch.float32 and tuple(tlogits.shape) == (B, 256)
    _close(tlogits, jlogits)
    assert len(tcaches) == tm.cfg.n_layers
    for i, c in enumerate(tcaches):
        want = _jax_layer(jcaches, i)
        assert tuple(c["k"].shape) == want["k"].shape == (B, S, 4, 16)
        np.testing.assert_array_equal(c["pos"].numpy(), want["pos"])
        _close(c["k"], want["k"])
        _close(c["v"], want["v"])

    jdecode, tdecode = jserve.build_decode_step(jm, mesh), tserve.build_decode_step(tm)
    jc, tc = jm.init_cache(B, S + NEW), tm.init_cache(B, S + NEW, device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(tm.cache_shapes(B, S + NEW)[0])] == \
        [tuple(x.shape) for x in (jc["body"][0]["k"][0], jc["body"][0]["pos"][0],
                                  jc["body"][0]["v"][0])]
    assert int(tc[0]["pos"].min()) == -1
    tok = None
    for p in range(S + NEW - 1):
        inp = toks[:, p:p + 1] if p < S else tok
        positions = np.full((B, 1), p, np.int32)
        jl, jc = jdecode(jp, jc, {"inputs": jnp.asarray(inp), "positions": jnp.asarray(positions)})
        tl, tc = tdecode(tp, tc, {"inputs": torch.from_numpy(inp),
                                  "positions": torch.from_numpy(positions)})
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
        assert (tl.argmax(-1).numpy() == tok[:, 0]).all(), p
    for i, c in enumerate(tc):
        want = _jax_layer(jc, i)
        np.testing.assert_array_equal(c["pos"].numpy(), want["pos"])
        _close(c["k"], want["k"])
        _close(c["v"], want["v"])


def test_decode_after_prefill_overwrites_slot_zero_as_jax_does(models):
    """JAX's prefill returns a cache exactly as deep as the prompt, so a
    decode straight after it, at position S, writes slot S % S = 0: the
    position slots read [S, 1, ..., S - 1] on both sides, and the logits
    agree (and differ from the full forward's, which sees position 0)."""
    jm, tm, jp, tp, mesh = models
    toks, pos = _prompt(16, seed=3)
    _, jcaches = jax.jit(jm.prefill)(jp, {"inputs": jnp.asarray(toks),
                                          "positions": jnp.asarray(pos)})
    _, tcaches = tm.prefill(tp, {"inputs": torch.from_numpy(toks),
                                 "positions": torch.from_numpy(pos)})
    nxt = np.array([[3], [4]], np.int32)
    dec = {"inputs": nxt, "positions": np.full((B, 1), 16, np.int32)}
    jl, jc = jax.jit(jm.decode_step)(jp, jcaches, {k: jnp.asarray(v) for k, v in dec.items()})
    with torch.no_grad():
        tl, tc = tm.decode_step(tp, tcaches, {k: torch.from_numpy(v) for k, v in dec.items()})
    slots = [16] + list(range(1, 16))
    for i, c in enumerate(tc):
        assert c["pos"].tolist() == [slots] * B
        np.testing.assert_array_equal(c["pos"].numpy(), _jax_layer(jc, i)["pos"])
    _close(tl, jl)
    full = {"inputs": np.concatenate([toks, nxt], axis=1),
            "positions": np.broadcast_to(np.arange(17, dtype=np.int32), (B, 17)).copy()}
    with torch.no_grad():
        h = tm.forward_hidden(tp, {k: torch.from_numpy(v) for k, v in full.items()})
    ref = (h[:, -1] @ tm.head_weight(tp)).numpy()
    assert float(np.abs(tl.numpy() - ref).max()) > REL_TOL * float(np.abs(ref).max())


class _Float64Everywhere:
    """``torch`` with ``float32`` read as ``float64``, for the modules that
    compute in float32 whatever the model's dtype (norms, RoPE, attention)."""

    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_decode_after_a_padded_prefill_is_the_full_forward(precision, monkeypatch):
    """Decode of token S after a prefill of S tokens whose cache is padded to
    S + 1 (as chip_smoke.py checks at full width) against forward_hidden's
    last logits over the S + 1 tokens: in float32 within REL_TOL (the two
    round in other orders: a one-token query against the cache, the chunked
    online softmax), and in float64 throughout, the float32 casts of the
    norms, RoPE and attention included, equal to 1e-12, so the cache write,
    the masks and the decode chunking add nothing but rounding."""
    cfg = get_config("qwen1.5-4b", smoke=True)
    if precision == "float64":
        for mod in (tattention, tcommon, tmodel, trope, tserve):
            monkeypatch.setattr(mod, "torch", _Float64Everywhere())
        cfg = dataclasses.replace(cfg, dtype="float64")
    tm = Model(cfg)
    tp = tm.init(0, "cpu")
    toks, pos = (torch.from_numpy(a) for a in _prompt(S + 1, seed=5))
    with torch.no_grad():
        _, caches = tserve.build_prefill(tm)(tp, {"inputs": toks[:, :S],
                                                  "positions": pos[:, :S]})
        padded = tm.init_cache(B, S + 1, "cpu")
        for c, pc in zip(caches, padded):
            for key in ("k", "v", "pos"):
                pc[key][:, :S] = c[key]
        logits, _ = tserve.build_decode_step(tm)(tp, padded, {"inputs": toks[:, S:],
                                                              "positions": pos[:, S:]})
        ref = tm.forward_hidden(tp, {"inputs": toks, "positions": pos})[:, -1] @ tm.head_weight(tp)
    err = float((logits - ref).abs().max() / ref.abs().max())
    assert err <= (REL_TOL if precision == "float32" else 1e-12), err


def test_pack_and_unpack_ops_match_the_pallas_kernels_in_interpret_mode():
    """pack2bit_op / unpack2bit_op (the plain versions on the CPU) against
    JAX's pack2bit_2d / unpack2bit_2d kernels in interpret mode, odd shapes;
    any int8 byte packs as the plain version packs it (uint8 shifts)."""
    rng = np.random.RandomState(5)
    for shape in ((63,), (3, 1001)):
        t = rng.randint(-1, 2, shape).astype(np.int8)
        want = np.asarray(j_pack_op(jnp.asarray(t), interpret=True))
        got = pack2bit_op(torch.from_numpy(t))
        assert tuple(got.shape) == packed_shape(t.size)
        np.testing.assert_array_equal(got.numpy(), want)
        back = unpack2bit_op(got, t.size, shape)
        np.testing.assert_array_equal(back.numpy(), np.asarray(
            j_unpack_op(jnp.asarray(want), t.size, shape, interpret=True)))
        np.testing.assert_array_equal(back.numpy(), t)
    wild = rng.randint(-128, 128, 700).astype(np.int8)
    np.testing.assert_array_equal(pack2bit_op(torch.from_numpy(wild)).numpy(),
                                  np.asarray(j_pack_op(jnp.asarray(wild), interpret=True)))
    tkernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        pack2bit_cuda(torch.zeros(10, dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA"):
        unpack2bit_cuda(torch.zeros((32, 128), dtype=torch.uint8))
    assert tkernels.launch_counts()["pack2bit"] == tkernels.launch_counts()["unpack2bit"] == 0


def _leaves_like(tp, seed, lo=-4, hi=5, dtype=np.int32):
    rng = np.random.RandomState(seed)
    return [rng.randint(lo, hi, tuple(p.shape)).astype(dtype) for p in tree_leaves(tp)]


@pytest.mark.parametrize("quorum", [1, 2])
def test_encoders_match_jax(models, quorum):
    """encode_weight_update's packed bytes (the deadband applied) and
    encode_weight_update8's level bytes and scale, bit for bit: the float
    updates are multiples of 1/8 in [-1, 1], so both sides' L2 norms are
    exact sums."""
    _, tm, _, tp, _ = models
    for v in _leaves_like(tp, 11):
        want = np.asarray(jserve.encode_weight_update(jnp.asarray(v), quorum=quorum,
                                                      backend="jnp"))
        for backend in (None, "torch"):
            got = tserve.encode_weight_update(torch.from_numpy(v), quorum=quorum,
                                              backend=backend)
            np.testing.assert_array_equal(got.numpy(), want)
    for i, u in enumerate(_leaves_like(tp, 12, -8, 9)):
        u = u.astype(np.float32) / 8
        jpay, jsc = jserve.encode_weight_update8(jnp.asarray(u), seed=i + 1, counter_base=7,
                                                 backend="jnp")
        for backend in (None, "torch"):
            tpay, tsc = tserve.encode_weight_update8(torch.from_numpy(u), seed=i + 1,
                                                     counter_base=7, backend=backend)
            assert tsc.dtype == torch.float32
            assert np.float32(tsc).view(np.int32) == np.asarray(jsc, np.float32).view(np.int32)
            np.testing.assert_array_equal(tpay.numpy(), np.asarray(jpay))


def _ingest_inputs(tp, seed):
    votes = _leaves_like(tp, seed)
    packed = [np.array(jserve.encode_weight_update(jnp.asarray(v), backend="jnp"))
              for v in votes]
    upd8, scales8 = [], []
    for i, u in enumerate(_leaves_like(tp, seed + 1, -8, 9)):
        pay, sc = jserve.encode_weight_update8(jnp.asarray(u.astype(np.float32) / 8),
                                               seed=i, backend="jnp")
        upd8.append(np.array(pay))
        scales8.append(np.array(sc))
    return {"int8": [v.astype(np.int8) for v in votes], "packed2bit": packed,
            "packed8": upd8}, scales8


def _jax_tree(jp, leaves):
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp),
                                        [jnp.asarray(x) for x in leaves])


@pytest.mark.parametrize("wire", ["packed2bit", "int8", "packed8"])
def test_update_ingest_matches_jax(models, wire):
    """One ingest round on each downlink wire: the replica's parameters bit
    for bit JAX's build_update_ingest (the int8 wire with its quorum of 2;
    packed8 eagerly, and to two ulps against the jitted step); the plain
    backend and the default one agree; the parameters are written in
    place."""
    jm, tm, jp, tp, mesh = models
    updates, scales8 = _ingest_inputs(tp, 21)
    lr, quorum = 0.05, (2 if wire == "int8" else 1)
    scales = scales8 if wire == "packed8" else None
    jingest = jserve.build_update_ingest(jm, mesh, lr=lr, quorum=quorum, wire=wire,
                                         backend="jnp", donate=False)
    jargs = (jp, _jax_tree(jp, updates[wire])) + ((_jax_tree(jp, scales),) if scales else ())
    with jax.disable_jit():
        want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jingest(*jargs))]
    jitted = [np.asarray(x) for x in jax.tree_util.tree_leaves(jingest(*jargs))]
    for backend in (None, "torch"):
        params = tree_unflatten(tp, [p.clone() for p in tree_leaves(tp)])
        ingest = tserve.build_update_ingest(tm, lr=lr, quorum=quorum, wire=wire,
                                            backend=backend)
        ups = tree_unflatten(tp, [torch.from_numpy(u) for u in updates[wire]])
        sc = tree_unflatten(tp, [torch.tensor(s) for s in scales]) if scales else None
        before = tree_leaves(params)
        out = ingest(params, ups, sc)
        got = tree_leaves(out)
        assert all(a is b for a, b in zip(got, before))   # in place
        for a, b, c, p0 in zip(got, want, jitted, tree_leaves(tp)):
            np.testing.assert_array_equal(a.numpy().view(np.int32), b.view(np.int32))
            bound = 2 * np.spacing(np.abs(p0.numpy()) + np.abs(c))
            assert (np.abs(a.numpy() - c) <= bound).all()
        assert any((a.numpy() != p.numpy()).any() for a, p in zip(got, tree_leaves(tp)))


def test_scaled_packed2bit_ingest_matches_jax(models):
    """A packed ternary decision with one float32 scale a leaf applies p - lr
    * scale * decision (the mean rule, n_sel = 1), bit for bit JAX's eager
    step."""
    jm, tm, jp, tp, mesh = models
    votes = _leaves_like(tp, 31, -1, 2)
    packed = [np.array(jserve.encode_weight_update(jnp.asarray(v), backend="jnp"))
              for v in votes]
    scales = [np.float32(0.1 + 0.05 * i) for i in range(len(votes))]
    jingest = jserve.build_update_ingest(jm, mesh, lr=0.05, wire="packed2bit", backend="jnp",
                                         donate=False)
    with jax.disable_jit():
        want = jax.tree_util.tree_leaves(jingest(jp, _jax_tree(jp, packed),
                                                 _jax_tree(jp, scales)))
    params = tree_unflatten(tp, [p.clone() for p in tree_leaves(tp)])
    got = tserve.build_update_ingest(tm, lr=0.05, wire="packed2bit")(
        params, tree_unflatten(tp, [torch.from_numpy(p) for p in packed]),
        tree_unflatten(tp, [torch.tensor(s) for s in scales]))
    for a, b in zip(tree_leaves(got), want):
        np.testing.assert_array_equal(a.numpy().view(np.int32), np.asarray(b).view(np.int32))


def test_ingest_refusals_match_jax(models):
    jm, tm, jp, tp, mesh = models
    for kw in ({"wire": "fp32"}, {"wire": "packed2bit", "quorum": 2},
               {"wire": "packed8", "quorum": 3}):
        with pytest.raises(ValueError):
            jserve.build_update_ingest(jm, mesh, lr=0.1, **kw)
        with pytest.raises(ValueError, match="wire|quorum"):
            tserve.build_update_ingest(tm, lr=0.1, **kw)
    updates, _ = _ingest_inputs(tp, 41)
    zero = tree_unflatten(tp, [torch.zeros(()) for _ in tree_leaves(tp)])
    with pytest.raises(ValueError, match="decode scales"):
        tserve.build_update_ingest(tm, lr=0.1, wire="packed8")(
            tp, tree_unflatten(tp, [torch.from_numpy(u) for u in updates["packed8"]]))
    with pytest.raises(ValueError, match="packed2bit wire"):
        tserve.build_update_ingest(tm, lr=0.1, wire="int8")(
            tp, tree_unflatten(tp, [torch.from_numpy(u) for u in updates["int8"]]), zero)


def test_serve_launcher_runs_on_the_cpu(capsys):
    """python -m repro_torch.launch.serve on the smoke config: the prompt
    replayed through decode, greedy tokens, and two 2-bit update rounds."""
    out = launch_serve.main(["--arch", "qwen1.5-4b", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--tokens", "9", "--online-updates", "4"])
    assert out["tokens"] == 18 and out["decode_steps"] == 16 and out["updates"] == 2
    assert len(out["ingest_ms"]) == 2 and len(out["last_tokens"]) == 2
    assert all(0 <= t < 256 for t in out["last_tokens"])
    assert "applied 2 online weight-update rounds" in capsys.readouterr().out
