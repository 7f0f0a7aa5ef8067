"""Rotary position embeddings, the port of ``repro.models.rope.apply_rope``
(M-RoPE waits for qwen2-vl)."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim / 2] float32 inverse frequencies."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S] ints. Rotates
    the two halves of each head in float32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs      # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                          # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
