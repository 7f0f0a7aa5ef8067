"""Attention, the port of ``repro.models.attention``, in float32 as the JAX
package computes it: GQA with an online-softmax loop over KV chunks
(``chunked_attention``, optionally under a sliding window), causal
sliding-window self-attention over query chunks, each against its own KV
span (``windowed_attention``: O(S * window) work), and the one-token
``decode_attention`` against a KV cache or a ring of one. Each chunk's body
runs under ``torch.utils.checkpoint``, so its probabilities are recomputed
in the backward pass, not saved (the JAX scan's ``jax.checkpoint``)."""

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


def _masked_scores(qh, k_i, ok, n_heads: int):
    """qh [B, H, Sq, D] against k_i [B, C, KV, D] -> float32 scores [B, H, Sq,
    C], NEG_INF where ``ok`` [B, Sq, C] is false."""
    k_r = _repeat_kv(k_i, n_heads).to(torch.float32).permute(0, 2, 3, 1)   # [B,H,D,C]
    scores = torch.matmul(qh, k_r)
    return torch.where(ok[:, None, :, :], scores,
                       torch.full((), NEG_INF, dtype=torch.float32, device=scores.device))


def _chunk(acc, m, l, qh, k_i, v_i, p_i, ok_i, positions_q, causal: bool,
           window: Optional[int], n_heads: int):
    v_r = _repeat_kv(v_i, n_heads).to(torch.float32).transpose(1, 2)       # [B,H,C,D]
    ok = ok_i[:, None, :]
    if causal:
        ok = ok & (p_i[:, None, :] <= positions_q[:, :, None])
    if window is not None:
        ok = ok & (positions_q[:, :, None] - p_i[:, None, :] < window)
    scores = _masked_scores(qh, k_i, ok, n_heads)                           # [B,H,Sq,C]
    m_new = torch.maximum(m, scores.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.matmul(p, v_r)
    return acc, m_new, l_new


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      positions_q: torch.Tensor, positions_kv: torch.Tensor,
                      kv_valid: Optional[torch.Tensor] = None, causal: bool = True,
                      window: Optional[int] = None, chunk: int = 1024,
                      remat: bool = True) -> torch.Tensor:
    """q [B, Sq, H, D], k and v [B, Skv, KV, D], positions [B, S] ints ->
    [B, Sq, H, D] in q's dtype. Every KV chunk is visited (no causal skip),
    as in the JAX scan; with ``window``, a query sees only keys less than
    ``window`` positions behind it."""
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
                positions_q, causal, window, h)
        if remat:
            acc, m, l = checkpoint(_chunk, *args, use_reentrant=False)
        else:
            acc, m, l = _chunk(*args)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = torch.where(l[..., None] > 0, out, torch.zeros((), device=q.device))
    return out.transpose(1, 2).to(q.dtype)


def _window_chunk(q_i, pq_i, k_i, v_i, pk_i, window: int, n_heads: int):
    """One query chunk of ``windowed_attention``: a plain softmax over its KV
    span. q_i [B, H, cq, D], pq_i [B, cq], k_i and v_i [B, span, KV, D], pk_i
    [B, span] (-1: padding) -> [B, H, cq, D] float32."""
    ok = ((pk_i[:, None, :] <= pq_i[:, :, None])
          & (pq_i[:, :, None] - pk_i[:, None, :] < window)
          & (pk_i[:, None, :] >= 0))
    scores = _masked_scores(q_i, k_i, ok, n_heads)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    v_r = _repeat_kv(v_i, n_heads).to(torch.float32).transpose(1, 2)
    return torch.matmul(p / torch.clamp(l, min=1e-30), v_r)


def windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       positions: torch.Tensor, window: int, q_chunk: int = 512,
                       remat: bool = True) -> torch.Tensor:
    """Causal sliding-window self-attention: q [B, S, H, D], k and v [B, S,
    KV, D], ``positions`` [B, S] shared by queries and keys -> [B, S, H, D]
    in q's dtype. The sequence is padded to a multiple of ``q_chunk``; each
    query chunk attends to a KV span of ceil(window / q_chunk) * q_chunk +
    q_chunk keys ending with its own, the front padded with position -1."""
    b, s_orig, h, d = q.shape
    q_chunk = min(q_chunk, s_orig)
    pad_s = (-s_orig) % q_chunk
    span = -(-window // q_chunk) * q_chunk + q_chunk
    front = span - q_chunk
    pad = torch.nn.functional.pad
    # keys: the span's front, then the sequence's tail padding
    kp = pad(k, (0, 0, 0, 0, front, pad_s))
    vp = pad(v, (0, 0, 0, 0, front, pad_s))
    pos_p = pad(positions, (front, pad_s), value=-1)
    positions = pad(positions, (0, pad_s), value=-1)
    qh = pad(q.to(torch.float32) * (d ** -0.5), (0, 0, 0, 0, 0, pad_s)).transpose(1, 2)
    outs = []
    for i in range(0, s_orig + pad_s, q_chunk):
        args = (qh[:, :, i:i + q_chunk], positions[:, i:i + q_chunk], kp[:, i:i + span],
                vp[:, i:i + span], pos_p[:, i:i + span], window, h)
        outs.append(checkpoint(_window_chunk, *args, use_reentrant=False) if remat
                    else _window_chunk(*args))
    out = torch.cat(outs, dim=2).transpose(1, 2)      # [B, S + pad, H, D]
    return out[:, :s_orig].to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_pos: torch.Tensor, positions_q: torch.Tensor, *,
                     window: Optional[int] = None, chunk: int = 8192) -> torch.Tensor:
    """One-token attention over a KV cache or a ring of one: q [B, 1, H, D],
    the caches [B, W, KV, D], ``cache_pos`` [B, W] ints with -1 for an empty
    slot. Chunked over the cache, so a long cache holds only [B, H, chunk]
    score tiles."""
    return chunked_attention(q, k_cache, v_cache, positions_q=positions_q,
                             positions_kv=cache_pos, kv_valid=cache_pos >= 0, causal=True,
                             window=window, chunk=chunk, remat=False)
