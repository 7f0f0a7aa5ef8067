"""PyTorch/CUDA port of ``repro``: the SPARSIGNSGD / EF-SPARSIGNSGD federated
round on an NVIDIA H100, with its kernels written by hand in CUDA C++.

The JAX package ``repro`` is the reference; this package imports none of it.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another. A CUDA request without a card raises; it never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
