"""Worker sampling and report dropout on the counter hash, the port of
``repro.train.sampling``, bit for bit (no ``jax.random`` is involved).

Worker m participates in a round iff hash(round seed, m) < p_s: a masked
worker contributes zeros to the vote and leaves the divisor, which is the
same as not being sampled (Cor. 1). Its report arrives iff a second,
independent hash clears the dropout rate. Both are deterministic in (seed,
round, worker), so a restart reproduces the same participation sequence.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng

ROUND_STRIDE = 1_000_003


def _draw(seed, salt: int, round_idx, worker_idx) -> torch.Tensor:
    widx = torch.as_tensor(worker_idx, dtype=torch.int64)
    counter = ((int(round_idx) & prng.MASK32) * ROUND_STRIDE
               + (widx.to(torch.int64) & prng.MASK32)) & prng.MASK32
    # a host seed becomes a fill on the counter's device: a copy from the host
    # would wait for the card
    s = (torch.full((), prng.fold_seed_int(seed, salt, 1), dtype=torch.int64,
                    device=counter.device)
         if isinstance(seed, int) else prng.fold_seed(seed, salt, 1))
    return prng.uniform01(s, counter)


def _rate(p: float, like: torch.Tensor) -> torch.Tensor:
    # compared in float32, as a Python float meets a float32 array in JAX
    return torch.full((), float(p), dtype=torch.float32, device=like.device)


def _everyone(worker_idx) -> torch.Tensor:
    w = torch.as_tensor(worker_idx)
    return torch.ones(w.shape, dtype=torch.bool, device=w.device)


def participation_mask(seed, round_idx, worker_idx, p_sample: float) -> torch.Tensor:
    """bool per worker: does it participate this round?"""
    if p_sample >= 1.0:
        return _everyone(worker_idx)
    u = _draw(seed, 0xFA17, round_idx, worker_idx)
    return u < _rate(p_sample, u)


def report_mask(seed, round_idx, worker_idx, dropout: float) -> torch.Tensor:
    """bool per worker: does a sampled worker's report arrive this round? A
    distinct salt from ``participation_mask``, so the two masks are
    independent streams; ``dropout = 0`` is the fully reporting fleet."""
    if dropout <= 0.0:
        return _everyone(worker_idx)
    u = _draw(seed, 0xD0A7, round_idx, worker_idx)
    return u >= _rate(dropout, u)


def round_seed(base_seed, round_idx):
    """fold_seed(base_seed, 0x52D) + round * 0x9E3779B9 (mod 2^32): a host
    int for a host seed (the trainer's, a launch argument), else a tensor."""
    base = (prng.fold_seed_int(base_seed, 0x52D) if isinstance(base_seed, int)
            else prng.fold_seed(base_seed, 0x52D))
    return (base + (int(round_idx) & prng.MASK32) * prng.GOLDEN) & prng.MASK32
