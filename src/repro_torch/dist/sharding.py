"""Logical-axis rules and placement builders, the port of
``repro.dist.sharding``.

Model code names *logical* axes ("vocab", "heads", "ff", "expert", "batch",
"seq"); this module maps them onto mesh axes ('pod', 'data' = the paper's
workers; 'model' = tensor parallelism) and nulls any placement the actual
dims cannot honour. A spec is a tuple with one entry a dim: a mesh-axis
name, a tuple of names, or None, the port's stand-in for JAX's
``PartitionSpec``. The builders take a mesh *description* (``MeshDesc``, or
anything with a ``shape`` mapping of axis sizes), never devices.

``tp_param_placements`` gives each parameter leaf its placement on 'model'
(``Placement``: the sharded dim, or None): the simple trainer's
tensor-parallel layout (``train.step_simple``) and ``models.tensor_parallel``
read it, and ``train.step_streamed`` reads ``TP_RULES`` to keep its FSDP
shards off the axes tensor parallelism would claim.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence, Tuple

from repro_torch.core.compressors import tree_leaves, tree_unflatten

# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

#: parameter placement (Megatron TP / EP): every feature-parallel logical
#: axis maps onto 'model'; conflicts on one tensor resolve by
#: ``sanitize_spec``'s last-wins dedup
TP_RULES: Mapping[str, Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "ff": "model",
    "expert": "model",
}

#: training activations: batch over the worker axis, sequence between blocks
#: and features inside them over 'model' (Megatron-style sequence
#: parallelism, not ported: ROADMAP)
ACT_RULES_TRAIN: Mapping[str, Optional[str]] = {
    "batch": "data",
    "seq": "model",
    "heads": "model",
    "ff": "model",
    "expert": "model",
    "vocab": "model",
}

#: serving activations: no sequence axis; batch over the worker axes
ACT_RULES_SERVE: Mapping[str, Optional[str]] = {
    "batch": "data",
    "seq": None,
    "heads": "model",
    "ff": "model",
    "expert": "model",
    "vocab": "model",
}


@dataclasses.dataclass(frozen=True)
class MeshDesc:
    """A mesh's axis names and sizes, row-major: what the placement builders
    read of a mesh (JAX's ``mesh.shape`` and ``mesh.axis_names``)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh sizes {self.axis_sizes} and axes {self.axis_names} differ")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


# ---------------------------------------------------------------------------
# Spec construction and sanitation
# ---------------------------------------------------------------------------

def logical_to_spec(logical: Sequence[Optional[str]],
                    rules: Mapping[str, Optional[str]] = TP_RULES) -> tuple:
    """Map logical axis names to a raw spec: unknown and None axes stay
    unsharded; the result may repeat a mesh axis or not divide the dims
    (``sanitize_spec`` settles both against a shape)."""
    return tuple(rules.get(name) if name is not None else None for name in logical)


def _entry_names(entry) -> tuple:
    """Mesh-axis names of one spec entry (a name, or a tuple or list)."""
    return tuple(entry) if isinstance(entry, (list, tuple)) else (entry,)


def sanitize_spec(spec: Sequence, dims: Sequence[int], mesh) -> tuple:
    """Null the entries the dims cannot honour; dedup repeated mesh axes.

    Per dim, the product of the entry's axis sizes must divide a positive
    dim, else the entry becomes None; an entry naming one axis twice is
    None. A mesh axis claimed by several dims keeps only its LAST
    occurrence. Only ``mesh.shape`` is read. One entry a dim."""
    sizes = dict(mesh.shape)
    out = []
    for i, dim in enumerate(dims):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            out.append(None)
            continue
        names = _entry_names(entry)
        if len(set(names)) != len(names):
            out.append(None)
            continue
        size = math.prod(sizes[name] for name in names)
        out.append(entry if dim > 0 and dim % size == 0 else None)
    last = {}
    for i, entry in enumerate(out):
        if entry is None:
            continue
        for name in _entry_names(entry):
            if name in last:
                out[last[name]] = None
            last[name] = i
    return tuple(out)


# ---------------------------------------------------------------------------
# Whole-tree placements
# ---------------------------------------------------------------------------

def _tp_spec_list(model, mesh):
    """(the parameter-shape tree, each leaf's sanitized spec in flatten order)."""
    shapes = model.param_shapes()
    logical = _logical_leaves(model.param_logical_axes())
    return shapes, [sanitize_spec(logical_to_spec(lg), sd.shape, mesh)
                    for lg, sd in zip(logical, tree_leaves(shapes))]


def tp_param_specs(model, mesh):
    """The spec tree of the tensor-parallel parameter placement: replicated
    over the worker axes, feature axes over 'model', sanitized per leaf."""
    shapes, specs = _tp_spec_list(model, mesh)
    return tree_unflatten(shapes, specs)


def _logical_leaves(tree) -> list:
    """The logical-axis tuples of a ``param_logical_axes`` tree, in flatten
    order (a tuple of names is a leaf, not a sequence of leaves)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _logical_leaves(tree[k])]
    if isinstance(tree, tuple) and all(isinstance(a, (str, type(None))) for a in tree):
        return [tree]
    return [x for item in tree for x in _logical_leaves(item)]


@dataclasses.dataclass(frozen=True)
class Placement:
    """A leaf's place on the 'model' axis: the dim it is cut on (None:
    replicated) into ``parts`` equal slices, model rank m holding slice m."""

    dim: Optional[int]
    parts: int = 1

    @property
    def sharded(self) -> bool:
        return self.dim is not None and self.parts > 1


def tp_param_placements(model, mesh):
    """The tree of each parameter leaf's ``Placement`` on 'model' (the
    port's ``tp_param_shardings``)."""
    t = dict(mesh.shape).get("model", 1)
    shapes, specs = _tp_spec_list(model, mesh)
    out = []
    for spec in specs:
        dims = [i for i, e in enumerate(spec) if e is not None and "model" in _entry_names(e)]
        out.append(Placement(dims[0], t) if dims and t > 1 else Placement(None))
    return tree_unflatten(shapes, out)


#: decode-cache leaf layouts, positions counted from the END, so one entry
#: serves stacked (a leading repeat axis) and per-layer leaves
_CACHE_LAYOUT = {
    "k": {"batch": -4, "seq": -3, "heads": -2},
    "v": {"batch": -4, "seq": -3, "heads": -2},
    "pos": {"batch": -2, "seq": -1},
    "conv": {"batch": -3},
    "state": {"batch": -4, "heads": -3},
}


def cache_shardings_tree(cache_shapes, mesh, *, worker_axes: Sequence[str] = ("data",),
                         shard_seq: bool = False):
    """The spec tree of a decode cache: batch over the worker axes and
    kv-heads over 'model'; with ``shard_seq`` the cache's sequence axis over
    the worker axes instead, batch replicated. ``cache_shapes`` is any tree
    of dicts, lists and tuples whose dict entries named as in
    ``_CACHE_LAYOUT`` hold a shape (a tuple of ints, or anything with a
    ``shape``): JAX's stacked cache tree or the port's list of per-layer
    dicts. Every placement is sanitized against the leaf's dims."""
    wa = tuple(worker_axes)
    wa_entry = wa if len(wa) > 1 else wa[0]

    def one(name, shape):
        layout = _CACHE_LAYOUT[name]
        rank = len(shape)
        spec = [None] * rank
        if shard_seq:
            if "seq" in layout:
                spec[rank + layout["seq"]] = wa_entry
        else:
            spec[rank + layout["batch"]] = wa_entry
        if "heads" in layout:
            spec[rank + layout["heads"]] = "model"
        return sanitize_spec(spec, shape, mesh)

    def walk(t):
        if isinstance(t, dict):
            return {k: (one(k, tuple(getattr(v, "shape", v))) if k in _CACHE_LAYOUT
                        and _is_shape(v) else walk(v)) for k, v in t.items()}
        return type(t)(walk(v) for v in t)

    return walk(cache_shapes)


def _is_shape(x) -> bool:
    shape = getattr(x, "shape", x)
    return isinstance(shape, (tuple, list)) and all(isinstance(d, int) for d in shape)
