"""Model assembly, the port of ``repro.models.model``: embedding -> the
pattern blocks over their repeats -> final norm -> chunked LM-head loss.

Parameters are a tree of tensors with JAX's structure:
``{"blocks": ({name: (n_repeats, ...)},), "embed", "final_norm", "lm_head",
"tail": ({name: ...},)}`` (no ``lm_head`` with tied embeddings: the head is
``embed.T``, and the gradient reaches ``embed`` from both uses; no ``embed``
for embedding inputs, which are cast to the activation dtype; ``tail`` only
with a ``tail_pattern``: its blocks run after the repeats, unstacked), the
block leaves stacked over the repeats, so ``tree_leaves`` gives the JAX
flatten order (dict keys sorted) and the trainer's per-leaf seeds match. Remat
is ``torch.utils.checkpoint(use_reentrant=False)`` per block and per loss
chunk (and per attention chunk inside a block). ``superblock_apply`` runs one
repeat of the pattern on one layer's slices, the streamed trainer's unit.
An M-RoPE model reads ``batch["positions3"]`` [B, S, 3] beside
``positions``.

Serving: ``prefill`` and ``decode_step``. A decode cache is a list of
per-layer dicts (``{"k", "v", "pos"}`` for attention, ``{"conv", "state"}``
for mamba), one per block in execution order (repeat-major, then the tail),
where JAX stacks the layers of a pattern position; ``decode_step`` writes
into it in place.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.models import blocks as blocks_lib
from repro_torch.models.common import dense_init, rms_norm


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A parameter's shape and dtype (``jax.ShapeDtypeStruct``'s role): a
    leaf of the parameter-shape tree."""
    shape: tuple
    dtype: torch.dtype


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ------------------------------------------------------------ parameters

    def param_shapes(self) -> dict:
        """The parameter tree of ``ShapeDtype`` leaves."""
        cfg = self.cfg
        r, dt = cfg.n_repeats, cfg.activation_dtype
        blocks = tuple({k: ShapeDtype((r,) + shape, dtype)
                        for k, (shape, dtype) in blocks_lib.block_param_defs(cfg, s).items()}
                       for s in cfg.pattern)
        shapes = {"blocks": blocks, "final_norm": ShapeDtype((cfg.d_model,), dt)}
        if cfg.input_kind == "tokens":
            shapes["embed"] = ShapeDtype((cfg.vocab_size, cfg.d_model), dt)
        if not cfg.tie_embeddings:
            shapes["lm_head"] = ShapeDtype((cfg.d_model, cfg.vocab_size), dt)
        if cfg.tail_pattern:
            shapes["tail"] = tuple({k: ShapeDtype(shape, dtype) for k, (shape, dtype)
                                    in blocks_lib.block_param_defs(cfg, s).items()}
                                   for s in cfg.tail_pattern)
        return shapes

    def param_logical_axes(self) -> dict:
        """The parameter tree of logical axis-name tuples (JAX's
        ``param_logical_axes``): a stacked leaf's repeat axis is None."""
        cfg = self.cfg
        out = {"blocks": tuple({k: (None,) + axes for k, axes
                                in blocks_lib.block_logical_axes(cfg, s).items()}
                               for s in cfg.pattern),
               "final_norm": (None,)}
        if cfg.input_kind == "tokens":
            out["embed"] = ("vocab", None)
        if not cfg.tie_embeddings:
            out["lm_head"] = (None, "vocab")
        if cfg.tail_pattern:
            out["tail"] = tuple(blocks_lib.block_logical_axes(cfg, s) for s in cfg.tail_pattern)
        return out

    def tensor_parallel(self, mg):
        """This model run tensor-parallel over the model ranks of ``mg``
        (``models.tensor_parallel.TPModel``)."""
        from repro_torch.models.tensor_parallel import TPModel   # it imports blocks
        return TPModel(self, mg)

    def param_count(self) -> int:
        return sum(math.prod(s.shape) for s in tree_leaves(self.param_shapes()))

    def init(self, seed: int, device=None) -> dict:
        """Random parameters from ``seed`` on ``device``: zeros for 1-D leaves
        (norms, biases) and leaves whose last dim is 1, else the truncated
        normal of ``dense_init`` (fan-in = the leading dim, as JAX's init
        has it: the repeat count for a stacked leaf). One generator on the
        device draws the leaves in flatten order."""
        device = torch.device(device) if device is not None else torch.device("cuda")
        gen = torch.Generator(device=device).manual_seed(int(seed))

        def make(sd: ShapeDtype):
            if len(sd.shape) == 1 or sd.shape[-1] == 1:
                return torch.zeros(sd.shape, dtype=sd.dtype, device=device)
            return dense_init(gen, sd.shape, sd.dtype, device)

        shapes = self.param_shapes()
        return tree_unflatten(shapes, [make(sd) for sd in tree_leaves(shapes)])

    def head_weight(self, params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _layers(self, params):
        """(spec, block params) of every block in execution order: the
        repeats, then the tail. One unbind per stacked leaf: the backward
        stacks the repeats' gradients once, instead of one full-size
        gradient per repeat."""
        cfg = self.cfg
        per_repeat = [{k: v.unbind(0) for k, v in bp.items()} for bp in params["blocks"]]
        return ([(spec, {k: v[r] for k, v in bp.items()})
                 for r in range(cfg.n_repeats) for spec, bp in zip(cfg.pattern, per_repeat)]
                + list(zip(cfg.tail_pattern, params.get("tail", ()))))

    # ---------------------------------------------------------------- stages

    def embed_stage(self, params, batch) -> torch.Tensor:
        if self.cfg.input_kind == "tokens":
            return F.embedding(batch["inputs"].long(), params["embed"])
        return batch["inputs"].to(self.cfg.activation_dtype)

    def _block(self, spec, p, h, positions, positions3, remat: bool):
        if remat:
            return checkpoint(blocks_lib.block_forward, self.cfg, spec, p, h, positions,
                              positions3, use_reentrant=False)
        return blocks_lib.block_forward(self.cfg, spec, p, h, positions, positions3)

    def superblock_apply(self, block_slices, h, positions, positions3=None) -> torch.Tensor:
        """One repeat of the pattern: ``block_slices`` holds one dict of a
        layer's leaves a pattern position. As JAX's, each block is remat'ed
        on its own only in a pattern of several blocks, so recomputing the
        superblock holds one block's internals at a time."""
        remat = self.cfg.remat and len(self.cfg.pattern) > 1
        for spec, p in zip(self.cfg.pattern, block_slices):
            h = self._block(spec, p, h, positions, positions3, remat)
        return h

    def forward_hidden(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        h = self.embed_stage(params, batch)
        positions, positions3 = batch["positions"], batch.get("positions3")
        for spec, p in self._layers(params):
            h = self._block(spec, p, h, positions, positions3, cfg.remat)
        return rms_norm(h, params["final_norm"], cfg.norm_eps)

    def head_loss(self, params, h: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Chunked softmax cross-entropy over the sequence: never holds the
        [B, S, V] logits. Labels < 0 are ignored."""
        cfg = self.cfg
        w = self.head_weight(params)
        b, s, _ = h.shape
        c = min(cfg.loss_chunk, s)
        pad = (-s) % c
        if pad:
            h = F.pad(h, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=-1)
        nll = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, s + pad, c):
            args = (h[:, i:i + c], labels[:, i:i + c], w)
            if cfg.remat:
                part, n = checkpoint(_loss_chunk, *args, use_reentrant=False)
            else:
                part, n = _loss_chunk(*args)
            nll, cnt = nll + part, cnt + n
        return nll / torch.clamp(cnt, min=1.0)

    def loss(self, params, batch):
        h = self.forward_hidden(params, batch)
        loss = self.head_loss(params, h, batch["labels"])
        return loss, {"loss": loss}

    # --------------------------------------------------------------- serving

    def cache_shapes(self, batch_size: int, max_len: int) -> list:
        """One dict of ``ShapeDtype`` leaves per block, in execution order."""
        cfg = self.cfg
        specs = [spec for _ in range(cfg.n_repeats) for spec in cfg.pattern]
        return [{k: ShapeDtype(shape, dtype) for k, (shape, dtype)
                 in blocks_lib.block_cache_defs(cfg, spec, batch_size, max_len).items()}
                for spec in specs + list(cfg.tail_pattern)]

    def init_cache(self, batch_size: int, max_len: int, device=None) -> list:
        """An empty decode cache: zero K/V, conv rings and SSD states,
        position slots -1 (empty)."""
        device = torch.device(device) if device is not None else torch.device("cuda")

        def make(sd: ShapeDtype):
            if sd.dtype == torch.int32:
                return torch.full(sd.shape, -1, dtype=sd.dtype, device=device)
            return torch.zeros(sd.shape, dtype=sd.dtype, device=device)

        return [{k: make(sd) for k, sd in layer.items()}
                for layer in self.cache_shapes(batch_size, max_len)]

    def prefill(self, params, batch):
        """Forward that also emits the decode caches: (final hidden [B, S, D],
        caches). Each block's cache is as deep as the prompt, as JAX's is, or
        a ring of ``window`` slots under a shorter window."""
        h = self.embed_stage(params, batch)
        positions, positions3 = batch["positions"], batch.get("positions3")
        caches = []
        for spec, p in self._layers(params):
            h, cache = blocks_lib.block_forward(self.cfg, spec, p, h, positions, positions3,
                                                return_cache=True)
            caches.append(cache)
        return rms_norm(h, params["final_norm"], self.cfg.norm_eps), caches

    def decode_step(self, params, caches, batch):
        """One token for every sequence. batch: {"inputs": [B, 1] (or
        [B, 1, D] embeddings), "positions": [B, 1], for M-RoPE "positions3":
        [B, 1, 3]}. Returns (float32 logits [B, V], caches), the caches
        updated in place."""
        h = self.embed_stage(params, batch)
        positions, positions3 = batch["positions"], batch.get("positions3")
        for (spec, p), cache in zip(self._layers(params), caches):
            h, _ = blocks_lib.block_decode(self.cfg, spec, p, h, cache, positions, positions3)
        h = rms_norm(h, params["final_norm"], self.cfg.norm_eps)
        return (h[:, 0] @ self.head_weight(params)).to(torch.float32), caches


def _loss_chunk(h_i: torch.Tensor, y_i: torch.Tensor, w: torch.Tensor):
    logits = (h_i @ w).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, torch.clamp(y_i, min=0).long()[..., None])[..., 0]
    mask = (y_i >= 0).to(torch.float32)
    return torch.sum((logz - tgt) * mask), torch.sum(mask)


def params_from_numpy(tree, device="cpu") -> dict:
    """The JAX package's parameter tree as numpy arrays (``jax.tree_util``
    structure: dicts and tuples) -> the port's tree of tensors, leaf for leaf,
    dtypes kept (bfloat16 arrays, numpy's ``ml_dtypes`` kind, included)."""
    def conv(a):
        a = np.array(a)   # a writable copy
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return tuple(walk(v) for v in t)
        return conv(t)

    return walk(tree)
