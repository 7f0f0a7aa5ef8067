"""Meshes, the port's counterpart of ``repro.launch.mesh``.

A JAX mesh names the worker axes ('pod', 'data') and a 'model' axis for
tensor parallelism. The port keeps the worker axes and their sizes in a
``collectives.WorkerGroup`` and the 'model' axis in its ``ModelGroup``
(``WorkerGroup.model``): the devices are row-major over (worker axes...,
'model'), JAX's mesh order, each process of ``torch.distributed`` (when it
is initialised) holding a contiguous block of them, as whole workers with
every model rank or as some model ranks of one worker. One process holds
them all as leading dimensions. ``make_production_mesh`` describes the
production meshes (``dist.sharding.MeshDesc``): no launch of 256 processes
is ported. Nothing here touches a device at import time.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.dist.collectives import ModelGroup, WorkerGroup
from repro_torch.dist.sharding import MeshDesc


def worker_axes_of(mesh) -> tuple:
    """The paper's 'worker' axes of a mesh: every axis but 'model'."""
    return tuple(a for a in mesh.axis_names if a != "model")


#: (global ranks) -> (the default group it was made under, the process group)
_GROUPS: dict = {}


def _group_of(ranks) -> object:
    """The process group of these global ranks, made once and reused by a
    later mesh over them. Only its members call ``dist.new_group`` (local
    synchronization, a name hashed from the ranks): the other processes of
    the default group may build meshes over other subgroups meanwhile, or
    none."""
    key = tuple(int(r) for r in ranks)
    made = _GROUPS.get(key)
    if made is None or made[0] is not dist.group.WORLD:
        made = _GROUPS[key] = (dist.group.WORLD,
                               dist.new_group(list(key), use_local_synchronization=True))
    return made[1]


def _split_groups(n_workers: int, t: int, per: int, rank: int, members):
    """The process groups of a mesh whose processes hold ``per`` < T model
    ranks of one worker: (the worker group of this process's model ranks,
    its index there, the model group of its worker, its index there).
    ``rank`` is this process's index in the mesh's group, whose global
    ranks are ``members`` (``dist.get_process_group_ranks``); a process
    makes the two groups it belongs to."""
    blocks = t // per                       # processes a worker
    mine_w, mine_b = divmod(rank, blocks)
    # the processes of model block mine_b in worker order, and of worker
    # mine_w in rank order
    wgroup = _group_of(members[w * blocks + mine_b] for w in range(n_workers))
    mgroup = _group_of(members[mine_w * blocks + b] for b in range(blocks))
    return wgroup, mine_w, mgroup, mine_b


def make_mesh(shape, axes, *, group=None) -> WorkerGroup:
    """The worker group of a mesh of ``shape`` over ``axes`` (row-major),
    with its 'model' axis, if it names one, as ``WorkerGroup.model``. With
    ``torch.distributed`` initialised, the default group's processes split
    the devices into contiguous blocks; ``group`` picks a subgroup instead,
    whose processes alone call this (a mesh whose processes cut a worker's
    model ranks makes its worker and model groups over the subgroup's
    global ranks)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ")
    t = shape[axes.index("model")] if "model" in axes else None
    waxes = tuple(a for a in axes if a != "model")
    wsizes = tuple(s for a, s in zip(axes, shape) if a != "model")
    if not waxes:
        waxes, wsizes = ("data",), (1,)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return WorkerGroup(axes=waxes, sizes=wsizes,
                           model=ModelGroup(t) if t is not None else None)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if t is None:
        return WorkerGroup(axes=waxes, sizes=wsizes, group=group, rank=rank, world=world)
    n_workers = math.prod(wsizes)
    if (n_workers * t) % world:
        raise ValueError(f"{n_workers * t} devices do not split over {world} processes")
    per = n_workers * t // world
    if per % t == 0:      # whole workers, every model rank here
        return WorkerGroup(axes=waxes, sizes=wsizes, group=group, rank=rank, world=world,
                           model=ModelGroup(t))
    if t % per:
        raise ValueError(f"{per} devices a process cut the {t} model ranks of a worker "
                         f"unevenly")
    wgroup, widx, mgroup, mrank = _split_groups(n_workers, t, per, rank,
                                                dist.get_process_group_ranks(group))
    return WorkerGroup(axes=waxes, sizes=wsizes, group=wgroup, rank=widx, world=n_workers,
                       model=ModelGroup(t, offset=mrank * per, local=per, group=mgroup,
                                        rank=mrank, world=t // per))


def make_host_mesh(data: int = 4, model: int = 1, *, group=None) -> WorkerGroup:
    """``data`` workers on one ('data',) axis, as JAX's host mesh names them,
    and with ``model`` > 1 a 'model' axis of that size."""
    if model == 1:
        return make_mesh((data,), ("data",), group=group)
    return make_mesh((data, model), ("data", "model"), group=group)


def make_production_mesh(*, multi_pod: bool = False) -> MeshDesc:
    """The production mesh's description: (16, 16) ('data', 'model') = 256
    chips, or with ``multi_pod`` (2, 16, 16) ('pod', 'data', 'model')."""
    if multi_pod:
        return MeshDesc((2, 16, 16), ("pod", "data", "model"))
    return MeshDesc((16, 16), ("data", "model"))
