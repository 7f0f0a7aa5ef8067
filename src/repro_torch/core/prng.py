"""Counter-based hash RNG, bit for bit the stream of ``repro.core.prng``.

One Bernoulli draw per coordinate comes from ``mix(seed ^ hash(counter))``,
where ``counter`` is the logical (flat) coordinate index, so the CUDA kernels
regenerate the same stream in registers from ``(seed, counter_base + j)``.

PyTorch on the CPU has no ``>>`` or ``+`` for ``uint32``, so the tensor
functions carry uint32 values in int64 and mask every step with
``& 0xFFFFFFFF`` (int64 products wrap, and the low 32 bits stay exact).
The ``*_int`` twins compute seeds on the host as Python ints, so a seed
reaches a kernel as a launch argument without a device sync.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
C1 = 0x85EBCA6B
C2 = 0xC2B2AE35
GOLDEN = 0x9E3779B9


def _u32(x, like=None) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=torch.int64,
                        device=None if like is None else like.device)
    return t & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 over uint32 values held in int64."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = (x * C1) & MASK32
    x = x ^ (x >> 13)
    x = (x * C2) & MASK32
    return x ^ (x >> 16)


def hash_counter(seed, counter: torch.Tensor) -> torch.Tensor:
    """uint32 hash (in int64) of (seed, counter); seed broadcasts."""
    c = (_u32(counter) * GOLDEN) & MASK32
    s = _u32(seed, like=c)
    return mix32(c ^ mix32((s + GOLDEN) & MASK32))


def uniform01(seed, counter: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) from the top 24 bits (exact in float32)."""
    bits = hash_counter(seed, counter)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def fold_seed(seed, *salts: int) -> torch.Tensor:
    """Derive an independent stream seed; tensor form (any shape of seeds)."""
    s = _u32(seed)
    for salt in salts:
        s = mix32(s ^ ((int(salt) & MASK32) * GOLDEN & MASK32))
    return s


def mix32_int(x: int) -> int:
    """Host twin of ``mix32`` on a Python int."""
    x &= MASK32
    x ^= x >> 16
    x = (x * C1) & MASK32
    x ^= x >> 13
    x = (x * C2) & MASK32
    return x ^ (x >> 16)


def fold_seed_int(seed: int, *salts: int) -> int:
    """Host twin of ``fold_seed`` on Python ints."""
    s = int(seed) & MASK32
    for salt in salts:
        s = mix32_int(s ^ ((int(salt) & MASK32) * GOLDEN & MASK32))
    return s
