"""Serving step builders (prefill, decode) and online weight-update ingest
over the training wire, the port of ``repro.serve.decode``.

``build_update_ingest`` keeps a serving replica in lockstep with a live
training job: the trainer broadcasts each round's server decision, the
quorum-gated sign of the vote sum, on the 2-bit packed wire the uplink uses
(``encode_weight_update``, 0.25 B a coordinate), or, for a mean-server
trainer whose decision is a float delta, the qsgd8-quantized 8-bit
``packed8`` wire (``encode_weight_update8``, 1 B a coordinate + one float32
scale); the replica applies it through ``engine.server_apply``, the kernels
the trainer runs. On the card the 2-bit wire packs and unpacks through the
``pack2bit`` and ``unpack2bit`` kernels and applies through ``vote_update``;
the 8-bit wire quantizes through ``qsgd8_pack8``.

The builders take no mesh: the port serves on one card. The steps run under
``torch.no_grad``; ``decode`` and ``ingest`` write into the caches and the
parameters they are given, in place (where JAX donates them), and return
them. An M-RoPE model's prefill and decode batches carry ``positions3``
([B, S, 3] and [B, 1, 3]) beside ``positions``. ``serve_input_specs``
waits for the tensor-parallel placement rules of ``dist/sharding.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import engine
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.compressors import qsgd8_scale, tree_leaves, tree_unflatten
from repro_torch.kernels.common import from_2d, jnp_sign, to_2d
from repro_torch.kernels.pack2bit.ops import pack2bit_op, unpack2bit_op
from repro_torch.kernels.pack2bit.ref import pack2bit_ref, unpack2bit_ref
from repro_torch.kernels.pack8.ops import qsgd8_pack8_op
from repro_torch.kernels.pack8.ref import qsgd8_levels_ref
from repro_torch.models.model import Model

UPDATE_WIRES = ("packed2bit", "packed8", "int8")


def build_decode_step(model: Model):
    """``(params, caches, batch) -> (float32 logits [B, V], caches)``: one
    token for every sequence, the caches updated in place."""

    @torch.no_grad()
    def step(params, caches, batch):
        return model.decode_step(params, caches, batch)

    return step


def build_prefill(model: Model):
    """``(params, batch) -> (float32 last-position logits [B, V], caches)``;
    for an encoder-only model (``supports_decode=False``) ``(params, batch)
    -> the float32 loss`` of the full forward against ``batch["labels"]``,
    with no caches (JAX's per-frame probe)."""
    if not model.cfg.supports_decode:
        @torch.no_grad()
        def probe(params, batch):
            return model.head_loss(params, model.forward_hidden(params, batch), batch["labels"])

        return probe

    @torch.no_grad()
    def step(params, batch):
        h, caches = model.prefill(params, batch)
        return (h[:, -1] @ model.head_weight(params)).to(torch.float32), caches

    return step


def encode_weight_update8(update: torch.Tensor, *, seed, counter_base=0,
                          backend: Optional[str] = None):
    """Trainer-side 8-bit downlink encoder: a float server update -> ``(payload,
    scale)``, the canonical (rows, 512) int8 sign*level view (1 B a
    coordinate) and the float32 decode scale: the qsgd8 quantizer on the
    downlink, for mean-server trainers whose decision is a float delta. The
    replica applies ``p - lr * scale * levels`` through
    ``build_update_ingest(wire="packed8")``; the stochastic rounding draws from
    the uplink's counter stream."""
    backend = engine.resolve_backend(backend, update)
    with torch.no_grad():
        scale = qsgd8_scale(update)
        if backend == "torch":
            payload, _ = to_2d(qsgd8_levels_ref(update, scale, seed, counter_base).reshape(-1))
        else:
            payload = qsgd8_pack8_op(update, scale, seed, counter_base)
    return payload, scale


def encode_weight_update(vote_sum: torch.Tensor, *, quorum: int = 1,
                         backend: Optional[str] = None) -> torch.Tensor:
    """Trainer-side downlink encoder: an integer vote sum -> the 2-bit packed
    ternary decision ``where(|v| >= quorum, sign(v), 0)`` in the pack2bit
    canonical wire format. ``build_update_ingest`` is the inverse and apply.
    For scaled servers the round's decode scale rides beside the payload (one
    float32), as the uplink's ``CompressedGrad.scale`` does: pass it to the
    ingest step as ``scales``."""
    backend = engine.resolve_backend(backend, vote_sum)
    v = vote_sum.to(torch.int32)
    step = torch.where(torch.abs(v) >= quorum, jnp_sign(v),
                       torch.zeros((), dtype=torch.int32, device=v.device)).to(torch.int8)
    if backend == "torch":
        view, _ = to_2d(step.reshape(-1))
        return pack2bit_ref(view)
    return pack2bit_op(step)


def build_update_ingest(model: Model, *, lr, quorum: int = 1, wire: str = "packed2bit",
                        backend: Optional[str] = None):
    """``(params, updates, scales=None) -> params``: online weight-update
    ingest through ``engine.server_apply`` (the fused vote_update path),
    written into ``params`` in place, leaf by leaf.

    ``wire`` selects the downlink message format of each leaf:
      - ``"packed2bit"``: uint8 (rows, 128) canonical views from
        ``encode_weight_update``, 0.25 B a coordinate, unpacked by the
        ``unpack2bit`` kernel on the card;
      - ``"packed8"``: int8 (rows, 512) canonical sign*level views from
        ``encode_weight_update8``, 1 B a coordinate; ``scales`` is required
        (the qsgd8 decode scale of each leaf) and the replica applies the
        dequantized float delta ``p - lr * scale * levels`` (the mean rule,
        n_sel = 1);
      - ``"int8"``: raw ternary (or small-int vote-sum) tensors in the leaf
        shape.

    ``scales`` (a tree of float32 scalars shaped like ``params``) carries a
    shared per-leaf decode scale beside a packed2bit payload (TernGrad's
    magnitude-shared s_t); the replica then applies ``p - lr * scale *
    decision``. Without it, decisions apply at unit scale.

    The quorum deadband is applied by whichever side signs: packed updates
    arrive gated by the encoder and apply with quorum 1; the int8 wire
    carries raw sums and is gated here. ``backend="torch"`` runs the plain
    versions; the default follows the tensors."""
    if wire not in UPDATE_WIRES:
        raise ValueError(f"unknown update wire {wire!r}; known: packed2bit | packed8 | int8")
    if wire == "packed2bit" and quorum != 1:
        raise ValueError(
            "the packed2bit wire carries already-gated ternary decisions: apply the quorum "
            "deadband trainer-side in encode_weight_update(vote_sum, quorum=...); a "
            "replica-side quorum here would be silently ignored. Use wire='int8' to gate on "
            "the replica.")
    if wire == "packed8" and quorum != 1:
        raise ValueError(
            "the packed8 wire carries dequantized float deltas (sign*level * scale), not "
            "votes: a quorum deadband does not apply. Use a ternary wire to gate updates.")
    # the config only selects the server rule; the decision tensor is
    # compressor-agnostic (any ternary uplink gives the same wire format)
    cfg = CompressionConfig(server="majority_vote")

    def leaf(p, u, scale=None):
        be = engine.resolve_backend(backend, p)
        if wire == "packed8":
            levels = from_2d(u, p.numel(), p.shape)
            new_p, _ = engine.server_apply(p, levels, cfg, lr=lr, server="mean", n_sel=1.0,
                                           scale=scale, backend=be)
            return new_p
        if wire == "packed2bit":
            votes = (from_2d(unpack2bit_ref(u), p.numel(), p.shape) if be == "torch"
                     else unpack2bit_op(u, p.numel(), p.shape))
            q = 1   # the encoder applied the deadband
        else:
            votes, q = u, quorum
        if scale is not None:
            # a scaled downlink: the payload is the gated ternary decision,
            # so the mean rule with n_sel = 1 applies p - lr * scale * decision
            new_p, _ = engine.server_apply(p, votes, cfg, lr=lr, server="mean", n_sel=1.0,
                                           scale=scale, backend=be)
            return new_p
        new_p, _ = engine.server_apply(p, votes, cfg, lr=lr, quorum=q, backend=be)
        return new_p

    @torch.no_grad()
    def ingest(params, updates, scales=None):
        if wire == "packed8" and scales is None:
            raise ValueError("the packed8 downlink is meaningless without its decode scales: "
                             "pass the per-leaf float32 scales from encode_weight_update8")
        if scales is not None and wire == "int8":
            raise ValueError(
                "scaled ingest needs the packed2bit wire (already-aggregated ternary "
                "decisions); the int8 wire carries raw vote sums whose scale-free gating "
                "happens replica-side")
        ps, us = tree_leaves(params), tree_leaves(updates)
        ss = tree_leaves(scales) if scales is not None else [None] * len(ps)
        if not len(ps) == len(us) == len(ss):
            raise ValueError(f"{len(us)} updates and {len(ss)} scales for {len(ps)} "
                             f"parameter leaves")
        for p, u, sc in zip(ps, us, ss):
            p.copy_(leaf(p, u, sc))
        return tree_unflatten(params, ps)

    return ingest
