"""Deterministic synthetic data, a numpy copy of ``repro.data.synthetic``
(the same arrays for the same config).

LM tokens: a seeded Zipf-like unigram stream with injected bigram structure,
so losses decrease under training. Images for the paper's experiments:
class-conditional Gaussians around per-class means on a random
16-dimensional manifold. Every batch is a pure function of (seed, step)."""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    bigram_rank: int = 64     # structure strength


def _bigram_table(vocab: int, rank: int, seed: int) -> np.ndarray:
    """Low-rank 'next token' preference table (vocab -> preferred successor)."""
    rng = np.random.RandomState(seed ^ 0xB16_AA)
    return rng.randint(0, vocab, size=(rank,), dtype=np.int64)


def lm_batch(cfg: LMStreamConfig, step: int) -> dict:
    """One global batch: {'inputs', 'labels', 'positions'} int32 numpy arrays."""
    rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % (2**31 - 1))
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    base = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64) % v
    table = _bigram_table(v, cfg.bigram_rank, cfg.seed)
    follow = rng.rand(b, s) < 0.5
    nxt = table[base[:, :-1] % cfg.bigram_rank]
    seq = base.copy()
    seq[:, 1:][follow] = nxt[follow]
    inputs = seq[:, :-1].astype(np.int32)
    labels = seq[:, 1:].astype(np.int32)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return {"inputs": inputs, "labels": labels, "positions": positions}


def lm_stream(cfg: LMStreamConfig, start_step: int = 0) -> Iterator[dict]:
    """The batches of steps ``start_step``, ``start_step + 1``, ..."""
    step = start_step
    while True:
        yield lm_batch(cfg, step)
        step += 1


@dataclasses.dataclass(frozen=True)
class ImageDataConfig:
    n_classes: int = 10
    shape: tuple = (28, 28, 1)       # fashion-mnist-like; (32, 32, 3) cifar-like
    n_train: int = 10000
    n_test: int = 2000
    noise: float = 0.9
    seed: int = 0


def make_image_dataset(cfg: ImageDataConfig):
    """Returns (x_train, y_train, x_test, y_test) float32/int32 numpy arrays,
    images in NHWC."""
    rng = np.random.RandomState(cfg.seed ^ 0x1A6E)
    d = int(np.prod(cfg.shape))
    basis = rng.randn(16, d).astype(np.float32)
    codes = rng.randn(cfg.n_classes, 16).astype(np.float32)
    means = codes @ basis
    means /= np.linalg.norm(means, axis=1, keepdims=True)

    def sample(n, seed):
        r = np.random.RandomState(seed)
        y = r.randint(0, cfg.n_classes, size=n).astype(np.int32)
        x = means[y] + cfg.noise / np.sqrt(d) * r.randn(n, d).astype(np.float32)
        return x.reshape((n,) + cfg.shape).astype(np.float32), y

    x_tr, y_tr = sample(cfg.n_train, cfg.seed + 1)
    x_te, y_te = sample(cfg.n_test, cfg.seed + 2)
    return x_tr, y_tr, x_te, y_te
