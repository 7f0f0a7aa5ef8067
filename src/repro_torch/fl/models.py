"""Small models of the paper's §6 experiments over flat parameter vectors,
the port of ``repro.fl.models``.

The flat vector keeps the JAX package's layout bit for bit: ``ravel_pytree``
flattens the parameter dict in sorted key order (``mlp_fashion``:
b0,b1,b2,w0,w1,w2; ``cnn_cifar``: b1,b2,c1,c2,w1,w2), convolution kernels in
HWIO, and the dense layer after the convolutions reads activations flattened
in NHWC order. The counter-hash RNG indexes the flat coordinate, so any other
layout would draw other Bernoulli masks. ``apply_fn`` permutes to PyTorch's
OIHW/NCHW inside and back to NHWC before the flatten.

The port's own initialisation draws from a ``torch.Generator``; its numbers
differ from ``jax.random``'s. ``from_jax_vector`` carries a JAX vector (the
initial weights, an EF residual) over unchanged.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Layout:
    """Named parameter shapes in the flat vector's order (sorted names)."""

    entries: tuple  # ((name, shape), ...)

    @staticmethod
    def of(shapes: dict) -> "Layout":
        return Layout(tuple((k, tuple(shapes[k])) for k in sorted(shapes)))

    @property
    def size(self) -> int:
        return sum(math.prod(s) for _, s in self.entries)

    def unravel(self, v: torch.Tensor) -> dict:
        out, off = {}, 0
        for name, shape in self.entries:
            n = math.prod(shape)
            out[name] = v[off:off + n].reshape(shape)
            off += n
        return out


def _init_vector(layout: Layout, scales: dict, generator, device) -> torch.Tensor:
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    parts = []
    for name, shape in layout.entries:
        if name in scales:
            parts.append(torch.randn(shape, generator=gen).reshape(-1) * scales[name])
        else:
            parts.append(torch.zeros(math.prod(shape)))
    return torch.cat(parts).to(torch.float32).to(resolve_device(device))


def mlp_layout(in_dim: int = 784, hidden=(256, 128), n_classes: int = 10) -> Layout:
    dims = (in_dim,) + tuple(hidden) + (n_classes,)
    shapes = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[f"w{i}"] = (a, b)
        shapes[f"b{i}"] = (b,)
    return Layout.of(shapes)


def mlp_fashion(generator=None, in_dim: int = 784, hidden=(256, 128), n_classes: int = 10,
                *, device=None):
    """The paper's Fashion-MNIST net: 784-256-128-10 MLP with ReLU.
    Returns (flat vector, apply_fn(v, x) -> logits)."""
    layout = mlp_layout(in_dim, hidden, n_classes)
    n_layers = len(hidden) + 1
    scales = {f"w{i}": a ** -0.5 for i, a in enumerate((in_dim,) + tuple(hidden))}

    def apply_fn(v, x):
        p = layout.unravel(v)
        h = x.reshape(x.shape[0], -1)
        for i in range(n_layers):
            h = h @ p[f"w{i}"] + p[f"b{i}"]
            if i < n_layers - 1:
                h = torch.relu(h)
        return h

    apply_fn.layout = layout
    return _init_vector(layout, scales, generator, device), apply_fn


def cnn_layout(shape=(32, 32, 3), n_classes: int = 10, width: int = 32) -> Layout:
    c = shape[-1]
    flat = (shape[0] // 4) * (shape[1] // 4) * 2 * width
    return Layout.of({
        "c1": (3, 3, c, width),
        "c2": (3, 3, width, 2 * width),
        "w1": (flat, 128),
        "b1": (128,),
        "w2": (128, n_classes),
        "b2": (n_classes,),
    })


def cnn_cifar(generator=None, shape=(32, 32, 3), n_classes: int = 10, width: int = 32,
              *, device=None):
    """Reduced VGG-style CNN of the CIFAR-10 analog: two 3x3 conv + 2x2
    max-pool blocks and two dense layers. Inputs are NHWC."""
    layout = cnn_layout(shape, n_classes, width)
    c = shape[-1]
    flat = (shape[0] // 4) * (shape[1] // 4) * 2 * width
    scales = {"c1": (9 * c) ** -0.5, "c2": (9 * width) ** -0.5,
              "w1": flat ** -0.5, "w2": 128 ** -0.5}

    def apply_fn(v, x):
        p = layout.unravel(v)
        h = x.permute(0, 3, 1, 2)                                   # NHWC -> NCHW
        h = F.conv2d(h, p["c1"].permute(3, 2, 0, 1), padding=1)    # HWIO -> OIHW
        h = F.max_pool2d(torch.relu(h), 2)
        h = F.conv2d(h, p["c2"].permute(3, 2, 0, 1), padding=1)
        h = F.max_pool2d(torch.relu(h), 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)          # flatten in NHWC order
        h = torch.relu(h @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    apply_fn.layout = layout
    return _init_vector(layout, scales, generator, device), apply_fn


def from_jax_vector(vec: np.ndarray, device=None, *, layout: Layout | None = None) -> torch.Tensor:
    """A flat vector of the JAX package (initial weights, an EF residual) as
    the port's float32 tensor. The layouts are the same, so the values carry
    over unchanged; ``layout`` checks the length."""
    arr = np.asarray(vec, dtype=np.float32)
    if arr.ndim != 1:
        raise ValueError(f"expected a flat vector, got shape {arr.shape}")
    if layout is not None and arr.size != layout.size:
        raise ValueError(f"vector has {arr.size} values, the layout {layout.size}")
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


def xent_loss(apply_fn: Callable):
    def loss(v, x, y):
        logits = apply_fn(v, x)
        logz = torch.logsumexp(logits, dim=-1)
        tgt = torch.take_along_dim(logits, y.long()[:, None], dim=-1)[:, 0]
        return torch.mean(logz - tgt)
    return loss


@torch.no_grad()
def accuracy(apply_fn: Callable, v, x, y, batch: int = 512) -> float:
    n = x.shape[0]
    correct = 0
    for i in range(0, n, batch):
        logits = apply_fn(v, x[i:i + batch])
        correct += int((torch.argmax(logits, -1) == y[i:i + batch]).sum())
    return correct / n
