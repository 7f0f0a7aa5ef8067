"""Attention, the port of ``repro.models.attention``: GQA with an
online-softmax loop over KV chunks (``chunked_attention``), in float32 as the
JAX package computes it, and the one-token ``decode_attention`` against a KV
cache. Each chunk's body runs under ``torch.utils.checkpoint``, so its
probabilities are recomputed in the backward pass, not saved (the JAX scan's
``jax.checkpoint``). Sliding windows (the windowed variant, and a window in
decode) wait for the model families that use them."""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, C, KV, D] -> [B, C, H, D]."""
    b, c, n_kv, d = k.shape
    g = n_heads // n_kv
    if g == 1:
        return k
    return k[:, :, :, None, :].expand(b, c, n_kv, g, d).reshape(b, c, n_heads, d)


def _chunk(acc, m, l, qh, k_i, v_i, p_i, ok_i, positions_q, causal: bool, n_heads: int):
    k_r = _repeat_kv(k_i, n_heads).to(torch.float32).permute(0, 2, 3, 1)   # [B,H,D,C]
    v_r = _repeat_kv(v_i, n_heads).to(torch.float32).transpose(1, 2)       # [B,H,C,D]
    scores = torch.matmul(qh, k_r)                                          # [B,H,Sq,C]
    ok = ok_i[:, None, :]
    if causal:
        ok = ok & (p_i[:, None, :] <= positions_q[:, :, None])
    scores = torch.where(ok[:, None, :, :], scores,
                         torch.full((), NEG_INF, dtype=torch.float32, device=scores.device))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.matmul(p, v_r)
    return acc, m_new, l_new


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      positions_q: torch.Tensor, positions_kv: torch.Tensor,
                      kv_valid: Optional[torch.Tensor] = None, causal: bool = True,
                      chunk: int = 1024, remat: bool = True) -> torch.Tensor:
    """q [B, Sq, H, D], k and v [B, Skv, KV, D], positions [B, S] ints ->
    [B, Sq, H, D] in q's dtype. Every KV chunk is visited (no causal skip),
    as in the JAX scan."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    valid = (kv_valid if kv_valid is not None
             else torch.ones((b, skv), dtype=torch.bool, device=q.device))
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        positions_kv = torch.nn.functional.pad(positions_kv, (0, pad), value=-1)
        valid = torch.nn.functional.pad(valid, (0, pad), value=False)

    qh = (q.to(torch.float32) * (d ** -0.5)).transpose(1, 2)   # [B,H,Sq,D]
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (acc, m, l, qh, k[:, sl], v[:, sl], positions_kv[:, sl], valid[:, sl],
                positions_q, causal, h)
        if remat:
            acc, m, l = checkpoint(_chunk, *args, use_reentrant=False)
        else:
            acc, m, l = _chunk(*args)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = torch.where(l[..., None] > 0, out, torch.zeros((), device=q.device))
    return out.transpose(1, 2).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_pos: torch.Tensor, positions_q: torch.Tensor, *,
                     window: Optional[int] = None, chunk: int = 8192) -> torch.Tensor:
    """One-token attention over a KV cache: q [B, 1, H, D], the caches [B, W,
    KV, D], ``cache_pos`` [B, W] ints with -1 for an empty slot. Chunked over
    the cache, so a long cache holds only [B, H, chunk] score tiles."""
    if window is not None:
        raise NotImplementedError("windowed decode attention is not ported yet (ROADMAP.md: "
                                  "the windowed families follow the streamed trainer)")
    return chunked_attention(q, k_cache, v_cache, positions_q=positions_q,
                             positions_kv=cache_pos, kv_valid=cache_pos >= 0, causal=True,
                             chunk=chunk, remat=False)
