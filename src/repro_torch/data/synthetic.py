"""Deterministic synthetic image data for the paper's experiments, a numpy
copy of the image part of ``repro.data.synthetic`` (same arrays for the same
config): class-conditional Gaussians around per-class means on a random
16-dimensional manifold."""

from __future__ import annotations

import dataclasses

import numpy as np


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
