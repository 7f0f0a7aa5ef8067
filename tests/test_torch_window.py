"""The port's sliding-window attention and the gemma3-27b model against the
JAX package, on the CPU: ``windowed_attention`` (a sequence that is not a
whole number of query chunks) with its gradients, the windowed masks of
``chunked_attention`` and ``decode_attention``, the prefill's ring caches,
mirrors of JAX's two ring-cache tests, the model's leaves (stacked repeats
and the unstacked tail), its loss and gradients with the tail and tied
embeddings, prefill and decode past the window, and a checkpoint of the
tail's tree byte for byte against JAX's ``save``.

Tolerances: attention in float32 to ``REL_TOL`` = 2e-5 of the largest
magnitude, JAX's own tolerance for these functions (``tests/test_models.py``;
measured gaps 1e-7 to 5e-7); serving's logits and caches to ``REL_TOL`` too,
as ``tests/test_torch_serve.py`` holds qwen1.5-4b's; cache positions and
checkpoint bytes exactly. The model's gradients to ``GRAD_RTOL`` = 1e-3 of
each leaf's norm: at this size either side's float32 gradients lie up to
3.9e-4 of a leaf's norm from a float64 run of the port (the windowed
layers' small leaves), and 1.4e-4 from each other, so the gap is rounding.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.registry import get_config as jget_config
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro.serve import decode as jserve
from repro.train import checkpoint as jckpt
from repro.train.state import init_state as j_init_state
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.data.synthetic import LMStreamConfig, lm_batch
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.serve import decode as tserve
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.state import TrainState

REL_TOL = 2e-5     # of the largest magnitude: float32 in torch's order against XLA's
GRAD_RTOL = 1e-3   # of each leaf's norm, the model's gradients (see the module's text)
ARCH = "gemma3-27b"
B, S, H, KV, D = 2, 37, 4, 2, 16


def _close(got, want, tol=REL_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _qkv(seed=0, s=S):
    rng = np.random.RandomState(seed)
    f = np.float32
    return (rng.randn(B, s, H, D).astype(f), rng.randn(B, s, KV, D).astype(f),
            rng.randn(B, s, KV, D).astype(f),
            np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy())


@pytest.mark.parametrize("window,q_chunk", [(8, 8), (20, 16), (33, 16), (5, 8)])
def test_windowed_attention_and_its_gradients_match_jax(window, q_chunk):
    """37 positions: not a whole number of query chunks."""
    q, k, v, pos = _qkv(2)
    g = np.random.RandomState(3).randn(B, S, H, D).astype(np.float32)

    @jax.jit
    def jax_side(q, k, v):
        out, vjp = jax.vjp(lambda a, b, c: jattn.windowed_attention(
            a, b, c, positions=jnp.asarray(pos), window=window, q_chunk=q_chunk), q, k, v)
        return out, vjp(jnp.asarray(g))

    jout, jgrads = jax_side(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tout = tattn.windowed_attention(tq, tk, tv, positions=torch.from_numpy(pos), window=window,
                                    q_chunk=q_chunk)
    (tout * torch.from_numpy(g)).sum().backward()
    _close(tout, jout)
    for t, j in zip((tq, tk, tv), jgrads):
        _close(t.grad, j)


@pytest.mark.parametrize("causal", [True, False])
def test_windowed_chunked_attention_matches_jax(causal):
    q, k, v, pos = _qkv(4)
    args = dict(positions_q=pos, positions_kv=pos, causal=causal, window=11, chunk=16)
    j = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                **{a: jnp.asarray(x) if isinstance(x, np.ndarray) else x
                                   for a, x in args.items()})
    t = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                **{a: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                                   for a, x in args.items()})
    _close(t, j)


def test_windowed_decode_attention_over_a_ring_matches_jax():
    """One token at position 40 against a ring of 12 slots holding positions
    29..40 in slot order p % 12, one slot empty, under a window of 9."""
    rng = np.random.RandomState(5)
    q = rng.randn(B, 1, H, D).astype(np.float32)
    kc, vc = (rng.randn(B, 12, KV, D).astype(np.float32) for _ in range(2))
    cpos = np.stack([np.arange(29, 41, dtype=np.int32)] * B)
    cpos = np.take_along_axis(cpos, np.argsort(cpos % 12, axis=1), axis=1)
    cpos[1, 3] = -1
    qpos = np.full((B, 1), 40, np.int32)
    j = jattn.decode_attention(*map(jnp.asarray, (q, kc, vc, cpos, qpos)), window=9, chunk=8)
    t = tattn.decode_attention(*map(torch.from_numpy, (q, kc, vc, cpos, qpos)), window=9,
                               chunk=8)
    _close(t, j)


@pytest.mark.parametrize("smoke", [True, False])
def test_param_leaves_match_jax(smoke):
    """74 leaves in JAX's order (blocks, embed, final_norm, tail: no lm_head
    with tied embeddings), the six pattern blocks stacked over the repeats
    and the two tail blocks not; 28,288,237,824 parameters at full width,
    head_dim 168."""
    jleaves = jax.tree_util.tree_flatten_with_path(
        JModel(jget_config(ARCH, smoke=smoke)).param_shapes())[0]
    tm = Model(get_config(ARCH, smoke=smoke))
    tleaves = tree_leaves(tm.param_shapes())
    assert len(tleaves) == len(jleaves) == 74
    for (path, j), t in zip(jleaves, tleaves):
        assert tuple(t.shape) == tuple(j.shape), jax.tree_util.keystr(path)
        assert str(t.dtype).split(".")[-1] == str(j.dtype), jax.tree_util.keystr(path)
    assert sorted(tm.param_shapes()) == ["blocks", "embed", "final_norm", "tail"]
    if not smoke:
        assert tm.param_count() == 28_288_237_824 and tm.cfg.head_dim == 168


def test_ring_cache_bounds_window_memory():
    """Mirror of tests/test_serve.py's: windowed layers allocate min(window,
    max_len) slots, not max_len (the cache list is in execution order: the
    six pattern blocks, then the two tail blocks)."""
    shapes = Model(get_config(ARCH, smoke=True)).cache_shapes(batch_size=2, max_len=1024)
    assert len(shapes) == 8
    assert [c["k"].shape[1] for c in shapes] == [8, 8, 8, 8, 8, 1024, 8, 8]
    assert shapes[0]["pos"].shape == (2, 8)


def test_ring_cache_decode_beyond_window():
    """Mirror of tests/test_serve.py's: decoding past the window through a
    ring of 6 slots stays correct (ring overwrite) against the full forward,
    to the same 5e-3."""
    cfg = ModelConfig(name="w", family="dense", n_layers=2, d_model=32, n_heads=4,
                      n_kv_heads=2, d_ff=64, vocab_size=64,
                      pattern=(LayerSpec(mixer="attn", window=6),), dtype="float32",
                      attn_chunk=8, q_chunk=8, loss_chunk=8, remat=False)
    m = Model(cfg)
    params = m.init(1, "cpu")
    b, s_total = 1, 20
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 64, (b, s_total)).astype(np.int32))
    caches = m.init_cache(b, max_len=s_total, device="cpu")
    assert caches[0]["k"].shape[1] == 6
    decode = tserve.build_decode_step(m)
    for t in range(s_total - 1):
        logits, caches = decode(params, caches, {
            "inputs": toks[:, t:t + 1], "positions": torch.full((b, 1), t, dtype=torch.int32)})
    full = {"inputs": toks[:, :-1],
            "positions": torch.arange(s_total - 1, dtype=torch.int32).expand(b, -1)}
    with torch.no_grad():
        ref = m.forward_hidden(params, full)[:, -1] @ m.head_weight(params)
    assert float((logits - ref).abs().max()) < 5e-3


@pytest.fixture(scope="module")
def models():
    """The smoke model both ways, from JAX's parameters with every zero leaf
    (norms) given values."""
    jm, tm = JModel(jget_config(ARCH, smoke=True)), Model(get_config(ARCH, smoke=True))
    rng = np.random.RandomState(7)
    jp = jax.tree_util.tree_map(
        lambda x: x if np.asarray(x).any() else jnp.asarray(rng.randn(*x.shape) * 0.1, x.dtype),
        jm.init(jax.random.PRNGKey(1)))
    return jm, tm, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def test_loss_and_grads_match_jax(models):
    """21 tokens cross the window (8), the query chunk (8), the attention
    chunk (16) and the loss chunk (16), with a masked label; the tied head:
    embed's gradient is the sum of the embedding's and the head's."""
    jm, tm, jp, tp = models
    batch = lm_batch(LMStreamConfig(vocab_size=256, seq_len=21, global_batch=2, seed=3), 0)
    batch["labels"][0, -1] = -1
    jl, jg = jax.jit(jax.value_and_grad(lambda p, bt: jm.loss(p, bt)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    tl = tm.loss(tree_unflatten(tp, leaves), {k: torch.from_numpy(v) for k, v in batch.items()})[0]
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    for j, t in zip(jax.tree_util.tree_leaves(jg), tg):
        j, t = np.asarray(j), t.numpy()
        assert np.linalg.norm(t - j) <= GRAD_RTOL * np.linalg.norm(j) + 1e-12
    assert torch.equal(tm.head_weight(tp), tp["embed"].T)


def _jax_layer_caches(jc, cfg):
    """JAX's caches ({"body": stacked per pattern position, "tail"}) as the
    port's list in execution order."""
    out = [{k: np.asarray(v[r]) for k, v in jc["body"][i].items()}
           for r in range(cfg.n_repeats) for i in range(len(cfg.pattern))]
    return out + [{k: np.asarray(v) for k, v in c.items()} for c in jc.get("tail", ())]


def test_prefill_ring_caches_and_decode_match_jax(models):
    """A 21-token prefill: each windowed layer's cache is a ring of 8 slots
    equal to JAX's (positions bit for bit), the global layer's as deep as
    the prompt; then decode steps continuing from them past the window."""
    jm, tm, jp, tp = models
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 256, (2, 26)).astype(np.int32)
    pos = np.broadcast_to(np.arange(26, dtype=np.int32), (2, 26)).copy()
    mesh = j_host_mesh(1, 1)
    jlogits, jc = jserve.build_prefill(jm, mesh)(
        jp, {"inputs": jnp.asarray(toks[:, :21]), "positions": jnp.asarray(pos[:, :21])})
    tlogits, tc = tserve.build_prefill(tm)(
        tp, {"inputs": torch.from_numpy(toks[:, :21]), "positions": torch.from_numpy(pos[:, :21])})
    _close(tlogits, jlogits)
    want = _jax_layer_caches(jc, tm.cfg)
    assert [c["k"].shape[1] for c in tc] == [8, 8, 8, 8, 8, 21, 8, 8]
    for c, w in zip(tc, want):
        np.testing.assert_array_equal(c["pos"].numpy(), w["pos"])
        for k in ("k", "v"):
            _close(c[k], w[k])
    assert sorted(tc[0]["pos"][0].tolist()) == list(range(13, 21))
    jdecode, tdecode = jserve.build_decode_step(jm, mesh), tserve.build_decode_step(tm)
    for p in range(21, 26):
        batch = {"inputs": toks[:, p:p + 1], "positions": pos[:, p:p + 1]}
        jl, jc = jdecode(jp, jc, {k: jnp.asarray(v) for k, v in batch.items()})
        tl, tc = tdecode(tp, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
        _close(tl, jl)
    for c, w in zip(tc, _jax_layer_caches(jc, tm.cfg)):
        np.testing.assert_array_equal(c["pos"].numpy(), w["pos"])


def test_tail_tree_checkpoint_matches_jax(tmp_path):
    """A state whose parameters hold the tail tuple: the port's manifest and
    .npy files equal those JAX's save writes for the same state, byte for
    byte (the ``['tail'][i][...]`` names among them)."""
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), n_layers=7,
                               pattern=(JLayerSpec(mixer="attn"),) * 5 + (JLayerSpec(),),
                               tail_pattern=(JLayerSpec(window=8),), dtype="bfloat16")
    rng = np.random.RandomState(4)
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.randn(*x.shape), x.dtype),
                                JModel(jcfg).init(jax.random.PRNGKey(2)))
    jstate = j_init_state(jp, server="majority_vote", seed=0xFEEDBEEF)
    jstate.step = jnp.int32(3)
    tstate = TrainState(params=params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)),
                        ef_residual=None, step=3, seed=0xFEEDBEEF)
    names = [p for p, _ in ckpt._flatten_with_path(tstate)]
    assert any(n.startswith(".params['tail'][0]['") for n in names), names
    jdir, tdir = jckpt.save(str(tmp_path / "j"), 3, jstate), ckpt.save(str(tmp_path / "t"), 3,
                                                                       tstate)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    for name in os.listdir(jdir):
        with open(os.path.join(jdir, name), "rb") as f, open(os.path.join(tdir, name), "rb") as g:
            assert f.read() == g.read(), name

