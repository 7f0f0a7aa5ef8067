"""Checkpoints, the port of ``repro.train.checkpoint``: atomic, in the JAX
package's format, so a checkpoint either package writes is one the other
restores.

Format: one directory a step, ``step_{step:08d}``, holding a
``manifest.json`` (leaf paths, shapes, dtypes, the step, a structure
*fingerprint*) and one ``leaf_{i:05d}.npy`` a leaf in flatten order. A
write goes to ``<dir>.tmp`` and is published by ``os.rename`` (atomic on
POSIX), so a crash during a save never damages the newest checkpoint;
``keep`` rotation prunes the old steps. bfloat16 leaves are widened to
float32 on disk and narrowed on restore, which is exact.

Leaves are named with ``jax.tree_util.keystr``'s strings, built here: a
TrainState's fields in order (``.params``, ``.ef_residual``, ``.step``,
``.seed``), dict keys sorted (``['blocks']``), sequence indices (``[0]``);
``None`` is an empty subtree. The port's TrainState keeps ``step`` and
``seed`` as host ints; they are the 0-d ``int32`` and ``uint32`` leaves the
JAX state holds, and restore as ints. dtype strings are numpy's
(``bfloat16``, ``float32``, ``int32``, ``uint32``).

The fingerprint hashes every leaf's (path, shape, dtype): restoring into a
state whose tree does not match raises ``CheckpointMismatchError`` instead
of loading another run's weights (``train.loop`` catches it and starts
fresh, with a warning). A checkpoint holds whole leaves, so it restores at
any worker count M (majority-vote state has no per-worker terms), and with
``shardings`` (the streamed trainer's layout, ``step_streamed.
state_shardings``) onto this process's slices, in any number of processes.

A leaf on the card is written as ``np.save`` writes its host copy (the same
header, then the raw bytes), copied through a small pinned staging buffer
instead of a whole pageable host copy, which halves a save at full width. A
restore maps each file and copies it, or this process's slice of it, to the
leaf's device from there.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import warnings
from typing import Optional

import numpy as np
import torch

MANIFEST = "manifest.json"
STAGE_BYTES = 64 << 20   # the pinned staging buffer of a save from the card
# the host-int fields of a TrainState and the 0-d dtype JAX gives them
HOST_INT_DTYPES = {"step": np.int32, "seed": np.uint32}


class CheckpointMismatchError(ValueError):
    """The checkpoint's tree fingerprint does not match the restore target:
    it belongs to another model or run configuration."""


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _flatten_with_path(tree, path: str = "") -> list:
    """[(keystr path, leaf)] in ``jax.tree_util``'s flatten order. A host
    int of a dataclass field named in HOST_INT_DTYPES becomes its 0-d numpy
    value."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(path, tree)]
    if dataclasses.is_dataclass(tree):
        out = []
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if isinstance(v, int) and f.name in HOST_INT_DTYPES:
                v = HOST_INT_DTYPES[f.name](v)
            out += _flatten_with_path(v, f"{path}.{f.name}")
        return out
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten_with_path(v, f"{path}[{i}]")]
    raise TypeError(f"{path}: a checkpoint leaf must be a tensor or an array, not "
                    f"{type(tree).__name__}")


def _dtype_str(dtype) -> str:
    """numpy's name of a torch or numpy dtype (``bfloat16``, ``float32``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def _leaf_descs(tree) -> list[list]:
    """[[keypath, shape, dtype]] a leaf: the structural identity of a state
    (values excluded). Tensors, arrays and ``ShapeDtype`` leaves alike."""
    return [[p, [int(d) for d in leaf.shape], _dtype_str(leaf.dtype)]
            for p, leaf in _flatten_with_path(tree)]


def _fingerprint_of(descs: list) -> str:
    payload = json.dumps(descs, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def tree_fingerprint(tree) -> str:
    """Stable hex digest of the tree structure and per-leaf shapes and dtypes."""
    return _fingerprint_of(_leaf_descs(tree))


def _widened(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    return t.to(torch.float32) if t.dtype == torch.bfloat16 else t   # exact


def _write_leaf(path: str, leaf, stage: Optional[torch.Tensor]) -> None:
    """``np.save(path, host copy of leaf)``, bf16 widened to float32. A CUDA
    tensor's bytes go through the pinned ``stage``, a chunk at a time."""
    if not (isinstance(leaf, torch.Tensor) and leaf.is_cuda):
        np.save(path, _widened(leaf).numpy() if isinstance(leaf, torch.Tensor)
                else np.asarray(leaf))
        return
    t = _widened(leaf).contiguous()
    header = {"descr": np.lib.format.dtype_to_descr(np.dtype(_dtype_str(t.dtype))),
              "fortran_order": False, "shape": tuple(t.shape)}
    data = t.reshape(-1).view(torch.uint8)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        for a in range(0, data.numel(), stage.numel()):
            part = stage[:min(stage.numel(), data.numel() - a)]
            part.copy_(data[a:a + part.numel()])
            f.write(part.numpy().data)


def save(ckpt_dir: str, step: int, state, *, keep: int = 3, extra: Optional[dict] = None):
    """Atomically save a TrainState-like tree; returns the step's directory."""
    target = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = target + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    flat = _flatten_with_path(state)
    manifest = {
        "step": int(step),
        "n_leaves": len(flat),
        "paths": [p for p, _ in flat],
        "leaves": _leaf_descs(state),
        "fingerprint": tree_fingerprint(state),
        "extra": extra or {},
        "sharded": False,
    }
    on_card = any(isinstance(x, torch.Tensor) and x.is_cuda for _, x in flat)
    stage = torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True) if on_card else None
    for i, (_, leaf) in enumerate(flat):
        _write_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), leaf, stage)
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(target):
        shutil.rmtree(target)
    os.rename(tmp, target)  # atomic publish
    _rotate(ckpt_dir, keep)
    return target


def _rotate(ckpt_dir: str, keep: int):
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def latest_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, MANIFEST)):
                out.append(int(name[5:]))
    return sorted(out)


def _read_leaf(path: str, like, layout=None):
    """A saved leaf as ``like`` holds it: a tensor of like's dtype on like's
    device (the CPU for a ``ShapeDtype``), copied out of the mapped file (only
    ``layout``'s slice of it, when given), or a host int."""
    arr = np.load(path, mmap_mode="r")
    if layout is not None and not layout.whole:
        arr = layout.cut_array(arr)
    if isinstance(like, np.generic):
        return int(arr)
    if isinstance(like, np.ndarray):
        return np.array(arr, dtype=like.dtype)
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    with warnings.catch_warnings():   # read-only memory, only read: copied just below
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    t = t.to(device, copy=True)
    return t.to(like.dtype) if isinstance(like.dtype, torch.dtype) else t


def _unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in flatten order."""
    it = iter(leaves)

    def walk(t):
        if t is None:
            return None
        if _is_leaf(t):
            return next(it)
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{f.name: walk(getattr(t, f.name))
                                             for f in dataclasses.fields(t)})
        if isinstance(t, int):
            return next(it)
        if isinstance(t, dict):
            out = {k: walk(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        return type(t)(walk(v) for v in t)

    return walk(like)


def _is_layout(x) -> bool:
    return all(hasattr(x, a) for a in ("shape", "axis", "start", "size", "whole", "cut_array"))


def _flat_shardings(sh, like, path: str = "") -> list:
    """``shardings`` aligned with ``_flatten_with_path(like)``: a layout, or
    None (the whole leaf), a leaf; a None subtree holds whole leaves."""
    if like is None:
        return []
    if _is_leaf(like):
        if sh is not None and not _is_layout(sh):
            raise TypeError(f"{path}: shardings hold LeafLayout leaves "
                            f"(train.step_streamed.state_shardings) or None, not "
                            f"{type(sh).__name__}")
        return [sh]
    if dataclasses.is_dataclass(like):
        if sh is not None and type(sh) is not type(like):
            raise TypeError(f"{path}: shardings must mirror the {type(like).__name__} "
                            f"(train.step_streamed.state_shardings), not {type(sh).__name__}")
        out = []
        for f in dataclasses.fields(like):
            v = getattr(like, f.name)
            sub = getattr(sh, f.name) if sh is not None else None
            if isinstance(v, int) and f.name in HOST_INT_DTYPES:
                out.append(None)
            else:
                out += _flat_shardings(sub, v, f"{path}.{f.name}")
        return out
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in
                _flat_shardings(sh[k] if sh is not None else None, like[k], f"{path}[{k!r}]")]
    return [x for i, v in enumerate(like) for x in
            _flat_shardings(sh[i] if sh is not None else None, v, f"{path}[{i}]")]


def restore(ckpt_dir: str, like, *, step: Optional[int] = None, shardings=None):
    """Restore into the structure of ``like`` (a tree of tensors or
    ``ShapeDtype`` leaves): each leaf in like's leaf's dtype, on its device.
    Returns (state, manifest). ``shardings`` (a tree mirroring ``like``,
    ``LeafLayout`` leaves or None) restores onto a streamed layout: like's
    leaves are this process's slices, the checkpoint's the whole leaves, and
    each file is mapped and only the slice copied, so a resume at another M
    or in another number of processes re-cuts the slices from the same
    files. Each layout cuts its own piece of the mapped file (``cut_array``):
    ``step_tp.TPLeafLayout`` its block as its model slices stacked on a new
    leading axis, the tensor-parallel layout; ``step_streamed.LeafLayout``
    its shards, and under T its model slices' shards stacked so, at any
    (M, T)."""
    steps = latest_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    step = steps[-1] if step is None else step
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(src, MANIFEST)) as f:
        manifest = json.load(f)

    flat_like = _flatten_with_path(like)
    flat_sh = (_flat_shardings(shardings, like) if shardings is not None
               else [None] * len(flat_like))
    # the whole leaves' descriptions, whatever slice of them ``like`` holds
    descs = [[d[0], list(sh.shape) if sh is not None else d[1], d[2]]
             for d, sh in zip(_leaf_descs(like), flat_sh)]
    want_fp = _fingerprint_of(descs)
    got_fp = manifest.get("fingerprint")
    if got_fp is not None and got_fp != want_fp:
        want_desc = {(d[0], tuple(d[1]), d[2]) for d in descs}
        got_desc = {(d[0], tuple(d[1]), d[2]) for d in manifest.get("leaves", [])}
        diff = sorted(x[0] for x in want_desc.symmetric_difference(got_desc))[:8]
        raise CheckpointMismatchError(
            f"checkpoint {src} was written by a different model/config: "
            f"fingerprint {got_fp} != expected {want_fp} "
            f"(first differing leaves: {diff}). Point ckpt_dir at a fresh "
            f"directory, or delete the stale checkpoint.")
    # manifests without a fingerprint still get the structural checks
    if len(flat_like) != manifest["n_leaves"]:
        raise CheckpointMismatchError(
            f"leaf count mismatch: ckpt {manifest['n_leaves']} vs target {len(flat_like)}")
    if [p for p, _ in flat_like] != manifest["paths"]:
        raise CheckpointMismatchError("tree structure mismatch on restore")

    leaves = [_read_leaf(os.path.join(src, f"leaf_{i:05d}.npy"), leaf_like, sh)
              for i, ((_, leaf_like), sh) in enumerate(zip(flat_like, flat_sh))]
    return _unflatten(like, leaves), manifest
