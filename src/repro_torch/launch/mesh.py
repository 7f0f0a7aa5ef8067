"""Worker groups, the port's counterpart of ``repro.launch.mesh``.

A JAX mesh names the worker axes ('pod', 'data') and a 'model' axis for
tensor parallelism. The port keeps the worker axes and their sizes in a
``collectives.WorkerGroup``: the workers live as a leading dimension in this
process, split over the processes of ``torch.distributed`` when it is
initialised (rank-major). Tensor parallelism is not ported: a 'model' axis
wider than 1 raises. Nothing here touches a device at import time.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.dist.collectives import WorkerGroup


def make_mesh(shape, axes, *, group=None) -> WorkerGroup:
    """The worker group of a mesh of ``shape`` over ``axes`` (worker axes
    only, row-major). With ``torch.distributed`` initialised, the default
    group's processes split the workers rank-major; ``group`` picks another."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if "model" in axes:
        raise NotImplementedError("the 'model' (tensor-parallel) axis is not ported yet: "
                                  "build the worker group from the worker axes only")
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return WorkerGroup(axes=axes, sizes=shape)
    return WorkerGroup(axes=axes, sizes=shape, group=group, rank=dist.get_rank(group),
                       world=dist.get_world_size(group))


def make_host_mesh(data: int = 4, model: int = 1, *, group=None) -> WorkerGroup:
    """``data`` workers on one ('data',) axis, as JAX's host mesh names them."""
    if model != 1:
        raise NotImplementedError(f"a model axis of {model} (tensor parallelism) is not "
                                  f"ported yet; use --host-model 1")
    return make_mesh((data,), ("data",), group=group)


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError("the production meshes (16 x 16 and 2 x 16 x 16 chips, with "
                              "a tensor-parallel 'model' axis) are not ported yet")

