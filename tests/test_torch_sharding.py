"""The port's placement rules and meshes against the JAX package's, on the
CPU: ``repro_torch.dist.sharding`` (the rule tables, ``logical_to_spec``,
``sanitize_spec``, ``tp_param_specs``, ``cache_shardings_tree``) spec for
spec against ``repro.dist.sharding`` on JAX abstract meshes, for every
registry architecture, full and smoke; ``launch.mesh``'s (D, T) groups and
production descriptions against ``repro.launch.mesh``."""

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs.registry import ARCH_IDS as JARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.dist import sharding as jsh
from repro.dist.compat import abstract_mesh
from repro.launch import mesh as jmesh
from repro.models.model import Model as JModel
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.dist import sharding as tsh
from repro_torch.dist.sharding import MeshDesc
from repro_torch.launch import mesh as tmesh
from repro_torch.models.model import Model

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((1, 16), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]


def _spec(p) -> tuple:
    """A JAX PartitionSpec as the port's tuple (list entries as tuples)."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in p)


def test_rule_tables_are_jax_s():
    assert dict(tsh.TP_RULES) == dict(jsh.TP_RULES)
    assert dict(tsh.ACT_RULES_TRAIN) == dict(jsh.ACT_RULES_TRAIN)
    assert dict(tsh.ACT_RULES_SERVE) == dict(jsh.ACT_RULES_SERVE)


@pytest.mark.parametrize("logical", [("vocab", None), (None, "heads"), ("expert", None, "ff"),
                                     ("batch", "seq"), (None,), ("unknown", "ff")])
@pytest.mark.parametrize("rules", ["TP_RULES", "ACT_RULES_TRAIN", "ACT_RULES_SERVE"])
def test_logical_to_spec_matches_jax(logical, rules):
    assert tsh.logical_to_spec(logical, getattr(tsh, rules)) == _spec(
        jsh.logical_to_spec(logical, getattr(jsh, rules)))


# test_dist_infra's and test_dist_substrate's sanitize_spec cases, with the
# expectations they assert, on the (16, 16) mesh unless a case names another
SANITIZE_CASES = [
    (("model", None), (50280, 1024), (16, 16), (None, None)),
    (("model", None), (8192, 1024), (16, 16), ("model", None)),
    ((("data", "model"),), (512,), (16, 16), (("data", "model"),)),
    ((("data", "model"),), (128,), (16, 16), (None,)),
    (("model",), (0,), (16, 16), (None,)),
    (("data", "model"), (7, 32), (1, 16), ("data", "model")),
    (("model", None, "model"), (64, 32, 128), (16, 16), (None, None, "model")),
    (("model", None, "model"), (64, 32, 100), (16, 16), ("model", None, None)),
    ((("data", "data"),), (512,), (16, 16), (None,)),
    ((("data", "model"), "model"), (256, 64), (16, 16), (None, "model")),
    (("model",), (32, 64, 128), (16, 16), ("model", None, None)),
]


@pytest.mark.parametrize("spec,dims,shape,want", SANITIZE_CASES)
def test_sanitize_spec_matches_jax(spec, dims, shape, want):
    names = ("data", "model")
    jm, tm = abstract_mesh(shape, names), MeshDesc(shape, names)
    got = tsh.sanitize_spec(spec, dims, tm)
    assert got == want
    assert got == _spec(jsh.sanitize_spec(P(*spec), dims, jm))


def test_the_two_packages_have_one_registry():
    assert list(ARCH_IDS) == list(JARCH_IDS)


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_tp_param_specs_match_jax_on_every_arch(shape, axes, smoke):
    """Every leaf's sanitized spec, every registry architecture."""
    jm, tm = abstract_mesh(shape, axes), MeshDesc(shape, axes)
    for arch in ARCH_IDS:
        want = [_spec(p) for p in jax.tree_util.tree_leaves(
            jsh.tp_param_specs(JModel(jget_config(arch, smoke=smoke)), jm),
            is_leaf=lambda x: isinstance(x, P))]
        got = tsh._tp_spec_list(Model(get_config(arch, smoke=smoke)), tm)[1]
        assert got == want, arch
        pls = jax.tree_util.tree_leaves(
            tsh.tp_param_placements(Model(get_config(arch, smoke=smoke)), tm),
            is_leaf=lambda x: isinstance(x, tsh.Placement))
        for pl, spec in zip(pls, want):
            dims = [i for i, e in enumerate(spec) if e is not None and "model" in
                    (e if isinstance(e, tuple) else (e,))]
            assert pl.dim == (dims[0] if dims and tm.shape["model"] > 1 else None), arch


def _cache_specs(tree) -> list:
    return [_spec(s.spec) for s in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("shard_seq", [False, True])
def test_cache_placement_matches_jax(shape, axes, shard_seq):
    """JAX's stacked cache tree placed by both packages; and the port's own
    per-layer cache list, placed by the port, gives each layer the spec of
    its JAX leaf without the leading repeat axis (the layouts count from the
    end)."""
    jm, tm = abstract_mesh(shape, axes), MeshDesc(shape, axes)
    waxes = jmesh.worker_axes_of(jm)
    assert tmesh.worker_axes_of(tm) == tuple(waxes)
    for arch in ARCH_IDS:
        for batch, max_len in ((4, 64), (32, 2048)):
            jshapes = JModel(jget_config(arch, smoke=True)).cache_shapes(batch, max_len)
            want = _cache_specs(jsh.cache_shardings_tree(jshapes, jm, worker_axes=waxes,
                                                         shard_seq=shard_seq))
            as_shapes = jax.tree_util.tree_map(lambda s: tuple(s.shape), jshapes)
            got = tsh.cache_shardings_tree(as_shapes, tm, worker_axes=waxes,
                                           shard_seq=shard_seq)
            flat = jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(x, tuple)
                                             and all(e is None or isinstance(e, (str, tuple))
                                                     for e in x))
            assert flat == want, arch
            tcache = Model(get_config(arch, smoke=True)).cache_shapes(batch, max_len)
            tspecs = tsh.cache_shardings_tree(tcache, tm, worker_axes=waxes,
                                              shard_seq=shard_seq)
            for layer, specs in zip(tcache, tspecs):
                for name, sd in layer.items():
                    assert len(specs[name]) == len(sd.shape)


@pytest.mark.parametrize("data,model", [(4, 2), (2, 2), (1, 2), (8, 1)])
def test_host_mesh_groups(data, model):
    """make_host_mesh(D, T): D workers on 'data' and, when T > 1, a
    ModelGroup of T ranks, all held in one process."""
    g = tmesh.make_host_mesh(data, model)
    assert g.n_workers == data and g.local == data
    assert g.model_size == model
    if model > 1:
        assert g.model.local == model and list(g.model.ranks) == list(range(model))
    g2 = tmesh.make_mesh((2, data, model), ("pod", "data", "model"))
    assert g2.axes == ("pod", "data") and g2.n_workers == 2 * data
    assert g2.model_size == model


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_descriptions_match_jax(multi_pod):
    """The production meshes as descriptions: JAX's shape and axis names,
    and the same worker axes."""
    d = tmesh.make_production_mesh(multi_pod=multi_pod)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    jm = abstract_mesh(shape, names)
    assert d.axis_sizes == shape and d.axis_names == names
    assert dict(d.shape) == dict(jm.shape)
    assert tmesh.worker_axes_of(d) == tuple(jmesh.worker_axes_of(jm))
    assert d.size == int(np.prod(shape))


def test_production_launch_raises():
    from repro_torch.launch import train as tlaunch
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tlaunch.build_everything(tlaunch.parser().parse_args(
            ["--arch", "qwen1.5-4b", "--device", "cpu", "--mesh", "pod"]))
