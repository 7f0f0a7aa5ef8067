"""The port's kernels: hand-written CUDA C++ in ``csrc/``, each with its plain
PyTorch version in the family's ``ref.py``.

Each launch wrapper counts its launches in a plain integer (``.launches``),
so a run can show that its path went through the kernels."""

from __future__ import annotations

from repro_torch.kernels.ef_server.kernel import ef_server_cuda
from repro_torch.kernels.sparsign.kernel import sparsign_cuda
from repro_torch.kernels.ternary.kernel import ternary_cuda
from repro_torch.kernels.vote_update.kernel import vote_update_cuda, weighted_vote_update_cuda

WRAPPERS = {
    "sparsign": sparsign_cuda,
    "vote_update": vote_update_cuda,
    "ef_server": ef_server_cuda,
    "ternary": ternary_cuda,
    "weighted_vote_update": weighted_vote_update_cuda,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
