"""Tensor parallelism on the 'model' axis: Megatron's split of the dense
attention families, driven by ``dist.sharding.tp_param_placements``.

Parameters sit in the *TP layout*: a leaf the placement cuts on 'model' is a
tensor of this process's model slices stacked on a new leading axis
(``ModelGroup.local`` of them, rank order), a replicated leaf is the whole
tensor, held once a process. ``shard_tree`` and ``gather_tree`` convert
between whole leaves and the layout.

The split (``TPModel.loss``):

- column-parallel: ``wq``/``wk``/``wv`` (with ``bq``/``bk``/``bv``),
  ``w_gate``/``w_up`` and ``w1`` (with ``b1``); attention runs on each
  rank's heads;
- row-parallel: ``wo``, ``w_down`` and ``w2``, each followed by the ordered
  all-reduce (``collectives.tp_sum``); ``b2`` and the norms are replicated,
  ``b2`` added after the reduce;
- vocab-parallel embedding: each rank looks up the ids of its slice, the
  rest masked to zero, then the all-reduce;
- vocab-parallel head and cross-entropy: the max (exact), the sum of
  exponentials and the target logit are reduced over 'model'; tied
  embeddings (gemma3) use the embedding's slice as the head;
- a leaf cut off head boundaries (granite-34b's single kv head at T = 2,
  128 columns into halves of 64) is all-gathered over 'model' before use
  and its part computed replicated on each rank, every rank taking the kv
  heads its query heads read. Its wire, update and checkpoint still follow
  the placement.

The two conjugate operators are ``torch.autograd.Function``s: ``tp_copy``
(identity forward, the ordered all-reduce backward) and ``tp_reduce`` (the
reverse); ``tp_gather_leaf``'s backward is the ordered sum cut back to the
slices. A process runs its model ranks one after another inside each
block, in lockstep, so one process and several give the same bits.

Not ported yet under T > 1 (they raise): MoE blocks (the 'expert' axis is
expert parallelism), mamba2 blocks, query heads or FFN widths or
vocabularies the model axis does not divide.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.compressors import tree_leaves, tree_unflatten
from repro_torch.dist import collectives
from repro_torch.dist.collectives import ModelGroup
from repro_torch.dist.sharding import MeshDesc, tp_param_placements
from repro_torch.models import attention as attn_lib
from repro_torch.models.blocks import _rope_qk
from repro_torch.models.common import gelu, rms_norm, swiglu

# the block leaves each rank holds a slice of, and how the split uses them
COLUMN = ("wq", "wk", "wv", "bq", "bk", "bv", "w_gate", "w_up", "w1", "b1")
ROW = ("wo", "w_down", "w2")
KV_LEAVES = ("wk", "wv", "bk", "bv")


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} under tensor parallelism (a 'model' axis of size > 1) "
                               f"is not ported yet")


# ---------------------------------------------------------------------------
# The conjugate operators
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    """x -> one alias a local rank; backward: the ordered sum over all T
    ranks' gradients."""

    @staticmethod
    def forward(ctx, x, mg, n):
        ctx.mg = mg
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        like = next(g for g in grads if g is not None)
        grads = [g if g is not None else torch.zeros_like(like) for g in grads]
        return collectives.tp_sum(grads, ctx.mg), None, None


class _Reduce(torch.autograd.Function):
    """Local ranks' partials -> their ordered sum over all T ranks;
    backward: the output's gradient to every partial."""

    @staticmethod
    def forward(ctx, mg, *parts):
        ctx.n = len(parts)
        return collectives.tp_sum(parts, mg)

    @staticmethod
    def backward(ctx, grad):
        return (None,) + (grad,) * ctx.n


class _GatherLeaf(torch.autograd.Function):
    """Local ranks' slices of a leaf along ``dim`` -> the whole leaf, one copy
    a local rank; backward: the ordered sum of every rank's gradient of the
    whole leaf, cut back to the local slices."""

    @staticmethod
    def forward(ctx, mg, dim, *slices):
        ctx.mg, ctx.dim, ctx.size = mg, dim, slices[0].shape[dim]
        whole = collectives.tp_all_gather(slices, mg, dim)
        return tuple(whole.clone() for _ in slices)

    @staticmethod
    def backward(ctx, *grads):
        mg = ctx.mg
        like = next(g for g in grads if g is not None)
        grads = [g if g is not None else torch.zeros_like(like) for g in grads]
        total = collectives.tp_sum(grads, mg)
        return (None, None) + tuple(total.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous()
                                    for r in mg.ranks)


def tp_copy(x: torch.Tensor, mg: ModelGroup) -> tuple:
    return _Copy.apply(x, mg, mg.local)


def tp_reduce(parts, mg: ModelGroup) -> torch.Tensor:
    return _Reduce.apply(mg, *parts)


def tp_gather_leaf(slices, mg: ModelGroup, dim: int) -> tuple:
    return _GatherLeaf.apply(mg, dim, *slices)


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

def placements_for(model, size: int):
    """The parameter tree of ``Placement``s on a 'model' axis of ``size``."""
    return tp_param_placements(model, MeshDesc((size,), ("model",)))


def shard_leaf(x: torch.Tensor, pl, mg: ModelGroup) -> torch.Tensor:
    """A whole leaf -> its TP-layout form (this process's slices stacked, or
    the leaf itself when replicated)."""
    if not pl.sharded:
        return x
    pieces = x.chunk(pl.parts, dim=pl.dim)
    return torch.stack([pieces[r] for r in mg.ranks])


def gather_leaf(x: torch.Tensor, pl, mg: ModelGroup) -> torch.Tensor:
    """A TP-layout leaf -> the whole leaf (gathered over 'model')."""
    if not pl.sharded:
        return x
    return torch.cat(collectives.tp_gather(list(x.unbind(0)), mg), dim=pl.dim)


def shard_tree(tree, placements, mg: ModelGroup):
    return tree_unflatten(tree, [shard_leaf(x, pl, mg) for x, pl in
                                 zip(tree_leaves(tree), tree_leaves(placements))])


def gather_tree(tree, placements, mg: ModelGroup):
    return tree_unflatten(tree, [gather_leaf(x, pl, mg) for x, pl in
                                 zip(tree_leaves(tree), tree_leaves(placements))])


def slice_counter_map(shape, pl, rank: int) -> Optional[tuple]:
    """The counter map (run, leaf_run, offset) of model rank ``rank``'s slice
    of a leaf of the whole ``shape``: the slice is rows of ``run``
    contiguous coordinates of the leaf's rows of ``leaf_run``, at ``offset``
    in each (``kernels.common.counter_index``). None for a replicated leaf."""
    if not pl.sharded:
        return None
    inner = 1
    for d in shape[pl.dim + 1:]:
        inner *= int(d)
    leaf_run = int(shape[pl.dim]) * inner
    run = leaf_run // pl.parts
    return run, leaf_run, rank * run


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class TPModel:
    """A ``Model`` run tensor-parallel over ``mg``'s T ranks, parameters in
    the TP layout. ``loss(params, batch)`` is the model's loss (the same on
    every rank); its gradients are in the TP layout."""

    def __init__(self, model, mg: ModelGroup):
        cfg = model.cfg
        self.model, self.cfg, self.mg = model, cfg, mg
        t = mg.size
        self.placements = placements_for(model, t)
        for spec in tuple(cfg.pattern) + tuple(cfg.tail_pattern):
            if spec.mixer != "attn":
                raise not_ported(f"a {spec.mixer} block ({cfg.name})")
            if spec.moe:
                raise not_ported(f"the MoE FFN's expert parallelism ({cfg.name})")
        if cfg.n_heads % t:
            raise not_ported(f"{cfg.n_heads} query heads over {t} model ranks ({cfg.name})")
        shapes = model.param_shapes()
        pls = self.placements
        for bp, bpl in zip(tuple(shapes["blocks"]) + tuple(shapes.get("tail", ())),
                           tuple(pls["blocks"]) + tuple(pls.get("tail", ()))):
            for name, pl in bpl.items():
                if name in COLUMN + ROW and not pl.sharded:
                    raise not_ported(f"a replicated {name} of {tuple(bp[name].shape)} "
                                     f"({cfg.name})")
        for name in ("embed", "lm_head"):
            if name in pls and not pls[name].sharded:
                raise not_ported(f"a vocabulary of {cfg.vocab_size} over {t} ranks")
        self.kv_split = cfg.n_kv_heads % t == 0
        self.heads = cfg.n_heads // t
        self.rcfg = dataclasses.replace(
            cfg, n_heads=self.heads,
            n_kv_heads=cfg.n_kv_heads // t if self.kv_split else self.heads,
            d_ff=cfg.d_ff // t)

    # ------------------------------------------------------------ layers

    def _layers(self, params):
        """(spec, replicated leaves, per-rank sliced leaves, per-leaf slice
        dims) of every block in execution order."""
        cfg, pls = self.cfg, self.placements
        out = []
        for bp, bpl, spec in zip(params["blocks"], pls["blocks"], cfg.pattern):
            rep = {k: v.unbind(0) for k, v in bp.items() if not bpl[k].sharded}
            sl = {k: [x.unbind(0) for x in v.unbind(0)] for k, v in bp.items()
                  if bpl[k].sharded}
            dims = {k: bpl[k].dim - 1 for k in sl}
            out.append((spec, rep, sl, dims))
        layers = [(spec, {k: v[i] for k, v in rep.items()},
                   [{k: v[r][i] for k, v in sl.items()} for r in range(self.mg.local)], dims)
                  for i in range(cfg.n_repeats) for spec, rep, sl, dims in out]
        for bp, bpl, spec in zip(params.get("tail", ()), pls.get("tail", ()),
                                 cfg.tail_pattern):
            rep = {k: v for k, v in bp.items() if not bpl[k].sharded}
            sl = {k: v.unbind(0) for k, v in bp.items() if bpl[k].sharded}
            layers.append((spec, rep, [{k: v[r] for k, v in sl.items()}
                                       for r in range(self.mg.local)],
                           {k: bpl[k].dim for k in sl}))
        return layers

    def _block(self, spec, rep, ranks, dims, h, positions, positions3):
        cfg, rcfg, mg = self.cfg, self.rcfg, self.mg
        b, s, _ = h.shape
        hd = cfg.head_dim
        x = rms_norm(h, rep["ln1"], cfg.norm_eps)
        xs = tp_copy(x, mg)
        whole = {}
        if not self.kv_split:   # kv leaves cut off head boundaries: gathered
            for name in KV_LEAVES:
                if name in ranks[0]:
                    whole[name] = tp_gather_leaf([p[name] for p in ranks], mg, dims[name])
        parts = []
        for r, p in enumerate(ranks):
            xr = xs[r]
            q = xr @ p["wq"]
            if cfg.qkv_bias:
                q = q + p["bq"]
            if self.kv_split:
                k, v = xr @ p["wk"], xr @ p["wv"]
                if cfg.qkv_bias:
                    k, v = k + p["bk"], v + p["bv"]
                k = k.reshape(b, s, rcfg.n_kv_heads, hd)
                v = v.reshape(b, s, rcfg.n_kv_heads, hd)
            else:
                k, v = xr @ whole["wk"][r], xr @ whole["wv"][r]
                if cfg.qkv_bias:
                    k, v = k + whole["bk"][r], v + whole["bv"][r]
                first = (mg.offset + r) * self.heads
                k = attn_lib._repeat_kv(k.reshape(b, s, cfg.n_kv_heads, hd), cfg.n_heads)
                v = attn_lib._repeat_kv(v.reshape(b, s, cfg.n_kv_heads, hd), cfg.n_heads)
                k, v = k[:, :, first:first + self.heads], v[:, :, first:first + self.heads]
            q = q.reshape(b, s, self.heads, hd)
            q, k = _rope_qk(rcfg, spec, q, k, positions, positions3)
            if spec.window is not None and cfg.causal:
                out = attn_lib.windowed_attention(q, k, v, positions=positions,
                                                  window=spec.window,
                                                  q_chunk=min(cfg.q_chunk, s), remat=cfg.remat)
            else:
                out = attn_lib.chunked_attention(q, k, v, positions_q=positions,
                                                 positions_kv=positions, causal=cfg.causal,
                                                 window=spec.window, chunk=cfg.attn_chunk,
                                                 remat=cfg.remat)
            parts.append(out.reshape(b, s, self.heads * hd) @ p["wo"])
        h = h + tp_reduce(parts, mg)
        if not spec.ffn:
            return h
        x = rms_norm(h, rep["ln2"], cfg.norm_eps)
        xs = tp_copy(x, mg)
        if cfg.mlp_variant == "swiglu":
            parts = [swiglu(xs[r] @ p["w_gate"], xs[r] @ p["w_up"]) @ p["w_down"]
                     for r, p in enumerate(ranks)]
            return h + tp_reduce(parts, mg)
        parts = [gelu(xs[r] @ p["w1"] + p["b1"]) @ p["w2"] for r, p in enumerate(ranks)]
        return h + (tp_reduce(parts, mg) + rep["b2"])

    # ------------------------------------------------------------ stages

    def embed_stage(self, params, batch) -> torch.Tensor:
        cfg, mg = self.cfg, self.mg
        if cfg.input_kind != "tokens":
            return batch["inputs"].to(cfg.activation_dtype)
        ids = batch["inputs"].long()
        width = cfg.vocab_size // mg.size
        parts = []
        for r, e in zip(mg.ranks, params["embed"].unbind(0)):
            local = ids - r * width
            ok = (local >= 0) & (local < width)
            rows = F.embedding(torch.where(ok, local, torch.zeros_like(local)), e)
            parts.append(torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                       device=rows.device)))
        return tp_reduce(parts, mg)

    def _head_slices(self, params) -> list:
        if self.cfg.tie_embeddings:
            return [e.T for e in params["embed"].unbind(0)]
        return list(params["lm_head"].unbind(0))

    def forward_hidden(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        h = self.embed_stage(params, batch)
        positions, positions3 = batch["positions"], batch.get("positions3")
        for spec, rep, ranks, dims in self._layers(params):
            if cfg.remat:
                h = checkpoint(self._block, spec, rep, ranks, dims, h, positions, positions3,
                               use_reentrant=False)
            else:
                h = self._block(spec, rep, ranks, dims, h, positions, positions3)
        return rms_norm(h, params["final_norm"], cfg.norm_eps)

    def head_loss(self, params, h: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """The chunked, vocab-parallel softmax cross-entropy (labels < 0
        ignored), ``Model.head_loss``'s chunks."""
        cfg = self.cfg
        ws = self._head_slices(params)
        b, s, _ = h.shape
        c = min(cfg.loss_chunk, s)
        pad = (-s) % c
        if pad:
            h = F.pad(h, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=-1)
        nll = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, s + pad, c):
            args = (h[:, i:i + c], labels[:, i:i + c], *ws)
            if cfg.remat:
                part, n = checkpoint(self._loss_chunk, *args, use_reentrant=False)
            else:
                part, n = self._loss_chunk(*args)
            nll, cnt = nll + part, cnt + n
        return nll / torch.clamp(cnt, min=1.0)

    def _loss_chunk(self, h_i, y_i, *ws):
        mg = self.mg
        width = self.cfg.vocab_size // mg.size
        hs = tp_copy(h_i, mg)
        logits = [(hs[r] @ w).to(torch.float32) for r, w in enumerate(ws)]
        with torch.no_grad():
            m = collectives.tp_max([lg.amax(dim=-1) for lg in logits], mg)
        s = tp_reduce([torch.exp(lg - m[..., None]).sum(dim=-1) for lg in logits], mg)
        logz = m + torch.log(s)
        picks = []
        for r, lg in zip(mg.ranks, logits):
            local = y_i.long() - r * width
            ok = (local >= 0) & (local < width)
            at = torch.where(ok, local, torch.zeros_like(local))
            pick = torch.gather(lg, -1, at[..., None])[..., 0]
            picks.append(torch.where(ok, pick, torch.zeros((), device=pick.device)))
        tgt = tp_reduce(picks, mg)
        mask = (y_i >= 0).to(torch.float32)
        return torch.sum((logz - tgt) * mask), torch.sum(mask)

    def loss(self, params, batch):
        h = self.forward_hidden(params, batch)
        loss = self.head_loss(params, h, batch["labels"])
        return loss, {"loss": loss}
