"""Rotary position embeddings, the port of ``repro.models.rope``: standard
RoPE and qwen2-vl's M-RoPE.

M-RoPE splits the head_dim / 2 frequency bands into three sections
(temporal, height, width); each section rotates by its own position stream.
For text tokens the three positions coincide, which gives standard RoPE."""

from __future__ import annotations

from typing import Sequence

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim / 2] float32 inverse frequencies."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of each head of x [..., S, H, Dh] by angles
    [..., S, Dh / 2] in float32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[..., None, :]                          # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S] ints."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float = 10000.0,
                sections: Sequence[int] = (16, 24, 24)) -> torch.Tensor:
    """qwen2-vl's M-RoPE. x: [..., S, H, Dh]; positions3: [..., S, 3] ints
    (t, h, w). Band i of the ``sections`` (counts summing to Dh / 2) takes
    its angle from position stream ``section_of(i)``."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to head_dim / 2 = "
                         f"{half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    sec_id = torch.repeat_interleave(torch.arange(3, device=x.device),
                                     torch.tensor(list(sections), device=x.device))
    pos = positions3.to(torch.float32)[..., sec_id]                 # [..., S, half]
    return _rotate(x, pos * freqs)
