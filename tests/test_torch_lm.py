"""The port's LM stack against the JAX package, on the CPU: the qwen1.5-4b
parameter leaves (shapes, dtypes and flatten order, which decide the
trainer's per-leaf seeds), and the loss and its gradients from the same
weights. The smoke config runs in float32; the loss is the same float32
computation in the same order (equal bit for bit here), the gradients agree
to 5e-5 of each leaf's norm: autograd and ``jax.grad`` sum in other orders,
and the measured gap is 1e-6 to 3e-5 on every leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models.model import Model as JModel
from repro.models.rope import apply_rope as j_rope
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.data.synthetic import LMStreamConfig, lm_batch
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.models.rope import apply_rope

GRAD_RTOL = 5e-5   # of each leaf's norm: autograd and jax.grad sum in other orders


def _jmodel(smoke=True):
    return JModel(jget_config("qwen1.5-4b", smoke=smoke))


def _tmodel(smoke=True):
    return Model(get_config("qwen1.5-4b", smoke=smoke))


@pytest.mark.parametrize("smoke", [True, False])
def test_param_leaves_match_jax(smoke):
    """Same leaves, shapes, dtypes and order: 15 leaves, the block leaves
    stacked over the repeats; 3,950,369,280 parameters at full width."""
    jleaves = jax.tree_util.tree_leaves(_jmodel(smoke).param_shapes())
    tleaves = tree_leaves(_tmodel(smoke).param_shapes())
    assert len(tleaves) == len(jleaves) == 15
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    if not smoke:
        assert _tmodel(False).param_count() == 3_950_369_280


def test_init_follows_the_jax_rule():
    """Zeros where JAX's init puts them (1-D leaves), a truncated normal of
    std fan_in ** -0.5 (fan-in = the leading dim) elsewhere."""
    tm = _tmodel()
    params = tm.init(3, device="cpu")
    jp = _jmodel().init(jax.random.PRNGKey(3))
    for t, j in zip(tree_leaves(params), jax.tree_util.tree_leaves(jp)):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        if j.ndim == 1:
            assert not t.any() and not j.any()
        else:
            std = j.shape[0] ** -0.5
            assert float(t.abs().max()) <= 2 * std + 1e-6
            assert 0.5 < float(t.std()) / float(j.std()) < 2.0
    again = tm.init(3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(again)))


def _batch(cfg, b, s, seed):
    return lm_batch(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                                   seed=seed), 0)


@pytest.mark.parametrize("b,s", [(2, 24), (1, 40)])
def test_loss_and_grads_match_jax(b, s):
    """Through params_from_numpy both compute from the same weights; 24 and
    40 tokens cross the attention chunk (16) and the loss chunk (16), with a
    ragged last chunk and a masked label."""
    jm, tm = _jmodel(), _tmodel()
    jp = jm.init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    batch = _batch(tm.cfg, b, s, seed=s)
    batch["labels"][0, -1] = -1
    jl, jg = jax.jit(jax.value_and_grad(lambda p, bt: jm.loss(p, bt)[0]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tl = tm.loss(tree_unflatten(tp, leaves), {k: torch.from_numpy(v) for k, v in batch.items()})[0]
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    for j, t in zip(jax.tree_util.tree_leaves(jg), tg):
        j, t = np.asarray(j), t.numpy()
        assert np.linalg.norm(t - j) <= GRAD_RTOL * np.linalg.norm(j) + 1e-12


def test_rope_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 3, 8).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) * 37, (2, 9)).copy()
    np.testing.assert_allclose(apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
                               np.asarray(j_rope(jnp.asarray(x), jnp.asarray(pos))),
                               rtol=1e-5, atol=1e-5)


def test_registry_names_the_ported_architectures():
    assert ARCH_IDS == ["qwen1.5-4b"]
    with pytest.raises(KeyError, match="qwen1.5-4b"):
        get_config("mamba2-370m")
