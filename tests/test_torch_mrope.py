"""The streamed architectures' models against the JAX package, on the CPU:
``rope.apply_mrope`` (qwen2-vl's M-RoPE) against ``repro.models.rope``, the
llama4-scout-17b-a16e and qwen2-vl-72b smoke models' loss and gradients from
JAX's parameters, qwen2-vl's prefill and decode against its own full
forward, and both full configs' leaves against JAX's ``param_shapes``.

Tolerances as ``tests/test_torch_moe.py`` states them: the rotation to
``REL_TOL`` = 1e-5 of the largest magnitude (float32 sines and cosines in
torch's order against XLA's), the models' gradients to ``GRAD_RTOL`` = 1e-3
of each leaf's norm, decode against the full forward to ``DECODE_TOL`` =
2e-5 of the largest logit in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models.model import Model as JModel
from repro.models.rope import apply_mrope as j_mrope
from repro_torch.configs.registry import get_config
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.models.rope import apply_mrope, apply_rope
from repro_torch.serve.decode import build_decode_step, build_prefill

REL_TOL = 1e-5
GRAD_RTOL = 1e-3
DECODE_TOL = 2e-5
ARCHS = ("llama4-scout-17b-a16e", "qwen2-vl-72b")


def _close(got, want, tol=REL_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.mark.parametrize("sections,dtype", [((16, 24, 24), np.float32), ((4, 2, 2), np.float32),
                                            ((16, 24, 24), jnp.bfloat16)])
def test_apply_mrope_matches_jax(sections, dtype):
    """Three distinct position streams (t, h, w), a band each section."""
    rng = np.random.RandomState(0)
    dh = 2 * sum(sections)
    x = rng.randn(2, 11, 3, dh).astype(np.float32)
    pos3 = rng.randint(0, 4000, (2, 11, 3)).astype(np.int32)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(j_mrope(jx, jnp.asarray(pos3), 1e6, sections).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
    got = apply_mrope(tx, torch.from_numpy(pos3), 1e6, sections).to(torch.float32)
    if dtype is jnp.bfloat16:   # one bf16 rounding of the same float32 rotation
        _close(got, want, 2.0 ** -7)
    else:
        _close(got, want)


def test_mrope_of_equal_streams_is_rope():
    """Text tokens: three equal position streams give standard RoPE."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 9, 2, 16).astype(np.float32))
    pos = torch.from_numpy(rng.randint(0, 100, (2, 9)).astype(np.int32))
    got = apply_mrope(x, pos[..., None].expand(2, 9, 3), 1e4, (2, 3, 3))
    assert torch.equal(got, apply_rope(x, pos, 1e4))
    with pytest.raises(ValueError, match="head_dim / 2"):
        apply_mrope(x, pos[..., None].expand(2, 9, 3), 1e4, (2, 3, 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_leaves_match_jax(arch):
    """Leaf paths' order, shapes and dtypes of the published configs: 16
    leaves for llama4-scout (107.8 B parameters), 14 for qwen2-vl-72b
    (71.5 B)."""
    jshapes = JModel(jget_config(arch)).param_shapes()
    jleaves = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tm = Model(get_config(arch))
    tleaves = tree_leaves(tm.param_shapes())
    assert len(tleaves) == len(jleaves) == (16 if arch == ARCHS[0] else 14)
    for (path, j), t in zip(jleaves, tleaves):
        assert tuple(t.shape) == tuple(j.shape), jax.tree_util.keystr(path)
        assert str(t.dtype).split(".")[-1] == str(j.dtype), jax.tree_util.keystr(path)
    assert tm.param_count() == sum(int(np.prod(j.shape)) for _, j in jleaves)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """The smoke model both ways, from JAX's parameters with every zero leaf
    (norms, biases) given values."""
    arch = request.param
    jm, tm = JModel(jget_config(arch, smoke=True)), Model(get_config(arch, smoke=True))
    rng = np.random.RandomState(7)
    jp = jax.tree_util.tree_map(
        lambda x: x if np.asarray(x).any() else jnp.asarray(rng.randn(*x.shape) * 0.1, x.dtype),
        jm.init(jax.random.PRNGKey(1)))
    return jm, tm, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _batch(cfg, b=2, s=21, seed=3):
    """21 positions cross the attention chunk (16) and the loss chunk (16);
    qwen2-vl's three position streams differ (t, then h and w offsets)."""
    rng = np.random.RandomState(seed)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    out = {"labels": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32), "positions": pos}
    out["labels"][0, -1] = -1
    if cfg.input_kind == "tokens":
        out["inputs"] = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    else:
        out["inputs"] = (rng.randn(b, s, cfg.d_model) * 0.3).astype(np.float32)
    if cfg.mrope:
        out["positions3"] = np.stack([pos, pos // 3, pos % 5], axis=-1).astype(np.int32)
    return out


def test_loss_and_grads_match_jax(models):
    jm, tm, jp, tp = models
    batch = _batch(tm.cfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, bt: jm.loss(p, bt)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tp)]
    tl = tm.loss(tree_unflatten(tp, leaves), {k: torch.from_numpy(v) for k, v in batch.items()})[0]
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    for j, t in zip(jax.tree_util.tree_leaves(jg), tg):
        j = np.asarray(j)
        t = np.zeros_like(j) if t is None else t.numpy()
        assert np.linalg.norm(t - j) <= GRAD_RTOL * np.linalg.norm(j) + 1e-12


def test_superblock_apply_is_the_forward_of_a_layer(models):
    """Model.superblock_apply over every layer's slices, then the final norm,
    is forward_hidden bit for bit: the streamed trainer's forward."""
    _, tm, _, tp = models
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg).items()}
    with torch.no_grad():
        want = tm.forward_hidden(tp, batch)
        h = tm.embed_stage(tp, batch)
        for r in range(tm.cfg.n_repeats):
            h = tm.superblock_apply(tuple({k: v[r] for k, v in bp.items()}
                                          for bp in tp["blocks"]), h, batch["positions"],
                                    batch.get("positions3"))
        from repro_torch.models.common import rms_norm
        got = rms_norm(h, tp["final_norm"], tm.cfg.norm_eps)
    assert torch.equal(got, want)


def test_qwen2_vl_prefill_and_decode_match_its_forward():
    """qwen2-vl's prefill of 17 embeddings, then decode of positions 17..20
    with their positions3, against forward_hidden's logits over the same 21
    inputs; the prefill's logits against the forward's at position 16."""
    tm = Model(get_config("qwen2-vl-72b", smoke=True))
    tp = tm.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg).items()}
    with torch.no_grad():
        h = tm.forward_hidden(tp, batch)
        ref = (h @ tm.head_weight(tp)).to(torch.float32)
    pre = {k: batch[k][:, :17] for k in ("inputs", "positions", "positions3")}
    logits, caches = build_prefill(tm)(tp, pre)
    _close(logits, ref[:, 16], DECODE_TOL)
    cache = tm.init_cache(2, 21, "cpu")
    for c, pc in zip(caches, cache):
        for key in c:
            pc[key][:, :c[key].shape[1]] = c[key]
    decode = build_decode_step(tm)
    for p in range(17, 21):
        step_batch = {k: batch[k][:, p:p + 1] for k in ("inputs", "positions", "positions3")}
        out, cache = decode(tp, cache, step_batch)
        _close(out, ref[:, p], DECODE_TOL)
    with pytest.raises(ValueError, match="positions3"):
        tm.forward_hidden(tp, {k: batch[k] for k in ("inputs", "positions")})
