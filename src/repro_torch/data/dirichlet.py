"""Heterogeneous federated partitions: Dirichlet(alpha) label skew (Hsu et al.
2019), a numpy copy of ``repro.data.dirichlet`` (same partitions for the
same arguments)."""

from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_workers: int, alpha: float,
                        seed: int = 0, min_per_worker: int = 8) -> list[np.ndarray]:
    """Per-worker index arrays; each worker's class mix ~ Dir(alpha)."""
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    for idx in by_class:
        rng.shuffle(idx)
    props = rng.dirichlet([alpha] * n_classes, size=n_workers)  # [M, C]
    # normalize per class so every example is assigned exactly once
    class_share = props / np.maximum(props.sum(axis=0, keepdims=True), 1e-12)
    workers: list[list[int]] = [[] for _ in range(n_workers)]
    for c in range(n_classes):
        counts = np.floor(class_share[:, c] * len(by_class[c])).astype(int)
        rem = len(by_class[c]) - counts.sum()
        order = np.argsort(-class_share[:, c])
        counts[order[:rem]] += 1
        start = 0
        for m in range(n_workers):
            workers[m].extend(by_class[c][start:start + counts[m]])
            start += counts[m]
    out = []
    all_idx = np.arange(len(labels))
    for m in range(n_workers):
        idx = np.array(sorted(workers[m]), dtype=np.int64)
        if len(idx) < min_per_worker:  # top up uniformly: every worker stays active
            extra = rng.choice(all_idx, size=min_per_worker - len(idx), replace=False)
            idx = np.concatenate([idx, extra])
        out.append(idx)
    return out

