"""The port's LM stack against the JAX package, on the CPU: the parameter
leaves of qwen1.5-4b, qwen2.5-32b (GQA with QKV bias) and granite-34b (MQA)
(shapes, dtypes and flatten order, which decide the trainer's per-leaf
seeds), and the loss and its gradients from the same weights. The smoke config runs in float32; the loss is the same float32
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


def _jmodel(smoke=True, arch="qwen1.5-4b"):
    return JModel(jget_config(arch, smoke=smoke))


def _tmodel(smoke=True, arch="qwen1.5-4b"):
    return Model(get_config(arch, smoke=smoke))


# the qwen1.5-4b cases keep their first ids
LEAF_CASES = [pytest.param("qwen1.5-4b", True, 15, id="True"),
              pytest.param("qwen1.5-4b", False, 15, id="False"),
              pytest.param("qwen2.5-32b", True, 15, id="qwen2.5-32b-smoke"),
              pytest.param("qwen2.5-32b", False, 15, id="qwen2.5-32b-full"),
              pytest.param("granite-34b", True, 12, id="granite-34b-smoke"),
              pytest.param("granite-34b", False, 12, id="granite-34b-full")]
FULL_PARAMS = {"qwen1.5-4b": 3_950_369_280}


@pytest.mark.parametrize("arch,smoke,n_leaves", LEAF_CASES)
def test_param_leaves_match_jax(arch, smoke, n_leaves):
    """Same leaves, shapes, dtypes and order: 15 leaves (12 for granite-34b,
    which has no QKV bias), the block leaves stacked over the repeats; at
    full width JAX's parameter count (3,950,369,280 for qwen1.5-4b)."""
    jleaves = jax.tree_util.tree_leaves(_jmodel(smoke, arch).param_shapes())
    tleaves = tree_leaves(_tmodel(smoke, arch).param_shapes())
    assert len(tleaves) == len(jleaves) == n_leaves
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    if not smoke:
        count = _tmodel(False, arch).param_count()
        assert count == sum(int(np.prod(j.shape)) for j in jleaves)
        assert count == FULL_PARAMS.get(arch, count)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_init_below_the_threshold_draws_as_before(dtype):
    """A leaf of at most SLICED_DRAW_COORDS coordinates is one float32 draw
    scaled in place: the bits of the draw scaled into a second tensor, as
    every model before the sliced draw was initialised."""
    from repro_torch.models.common import dense_init

    shape = (48, 3, 40)
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=torch.Generator().manual_seed(11))
    before = (t * 48 ** -0.5).to(dtype)
    got = dense_init(torch.Generator().manual_seed(11), shape, dtype, "cpu")
    as_int = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert got.dtype == dtype and torch.equal(got.view(as_int), before.view(as_int))


def test_dense_init_draws_a_large_leaf_slice_by_slice(monkeypatch):
    """Above the threshold (lowered here to 1,000 coordinates) the leaf is
    drawn one slice of its leading axis after the other: each slice is the
    generator's next draw, the std is fan_in ** -0.5 times the truncated
    normal's 0.8796, nothing lies past 2 std, and the slices differ."""
    from repro_torch.models import common

    monkeypatch.setattr(common, "SLICED_DRAW_COORDS", 1000)
    shape, fan_in = (6, 40, 50), 6
    got = common.dense_init(torch.Generator().manual_seed(5), shape, torch.bfloat16, "cpu")
    assert tuple(got.shape) == shape and got.dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(5)
    for i in range(shape[0]):
        t = torch.empty(shape[1:])
        torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
        assert torch.equal(got[i], (t * fan_in ** -0.5).to(torch.bfloat16))
    std = fan_in ** -0.5
    x = got.to(torch.float32)
    assert abs(float(x.std()) / (0.8796 * std) - 1) < 0.03
    assert float(x.abs().max()) <= 2 * std * (1 + 2 ** -8)
    assert not torch.equal(got[0], got[1])


def test_rope_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 3, 8).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) * 37, (2, 9)).copy()
    np.testing.assert_allclose(apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
                               np.asarray(j_rope(jnp.asarray(x), jnp.asarray(pos))),
                               rtol=1e-5, atol=1e-5)


def test_registry_names_the_ported_architectures():
    """The ported entries in the JAX registry's order, each with its trainer
    mode; an unported architecture raises and names the ported ones."""
    from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
    from repro.configs.registry import trainer_mode as j_trainer_mode
    from repro_torch.configs.registry import trainer_mode

    assert ARCH_IDS == ["gemma3-27b", "qwen2.5-32b", "granite-34b", "qwen1.5-4b",
                        "mamba2-370m", "hubert-xlarge", "qwen2-moe-a2.7b"]
    assert ARCH_IDS == [a for a in J_ARCH_IDS if a in ARCH_IDS]
    for arch in ARCH_IDS:
        assert trainer_mode(arch) == j_trainer_mode(arch) == "simple"
        for smoke in (True, False):
            assert get_config(arch, smoke) == _port_of(jget_config(arch, smoke))
    for arch in ("qwen2-vl-72b", "jamba-1.5-large-398b", "llama4-scout-17b-a16e"):
        assert j_trainer_mode(arch) == "streamed"
        with pytest.raises(KeyError, match="qwen2-moe-a2.7b"):
            get_config(arch)


def _port_of(jcfg):
    """JAX's config with the fields the port keeps (the MoE fields and
    ``q_chunk`` among them since the MoE and windowed families), in the
    port's types."""
    import dataclasses

    from repro_torch.configs.base import LayerSpec, ModelConfig

    kept = {f.name for f in dataclasses.fields(ModelConfig)}
    fields = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in kept}
    for k in ("pattern", "tail_pattern"):
        fields[k] = tuple(LayerSpec(**spec) for spec in fields[k])
    return ModelConfig(**fields)
