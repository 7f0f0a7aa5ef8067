"""The port's kernels: hand-written CUDA C++ in ``csrc/``, each with its plain
PyTorch version in the family's ``ref.py``.

Each launch wrapper counts its launches in a plain integer (``.launches``),
so a run can show that its path went through the kernels."""

from __future__ import annotations

from repro_torch.kernels.ef_server.kernel import ef_server_cuda
from repro_torch.kernels.golomb.kernel import (golomb_pack_cuda, sparsign_golomb_cuda,
                                               ungolomb_sum_cuda, ungolomb_wsum_cuda)
from repro_torch.kernels.pack2bit.kernel import (pack2bit_cuda, unpack2bit_cuda,
                                                 unpack2bit_sum_cuda, unpack2bit_wsum_cuda)
from repro_torch.kernels.pack8.kernel import qsgd8_pack8_cuda, unpack8_sum_cuda
from repro_torch.kernels.sparsign.kernel import sparsign_cuda
from repro_torch.kernels.sparsign_pack2bit.kernel import sparsign_pack2bit_cuda
from repro_torch.kernels.ternary.kernel import ternary_cuda, ternary_pack2bit_cuda
from repro_torch.kernels.vote_update.kernel import vote_update_cuda, weighted_vote_update_cuda

WRAPPERS = {
    "sparsign": sparsign_cuda,
    "vote_update": vote_update_cuda,
    "ef_server": ef_server_cuda,
    "ternary": ternary_cuda,
    "weighted_vote_update": weighted_vote_update_cuda,
    "sparsign_pack2bit": sparsign_pack2bit_cuda,
    "ternary_pack2bit": ternary_pack2bit_cuda,
    "unpack2bit_sum": unpack2bit_sum_cuda,
    "unpack2bit_wsum": unpack2bit_wsum_cuda,
    "sparsign_golomb": sparsign_golomb_cuda,
    "golomb_pack": golomb_pack_cuda,
    "ungolomb_sum": ungolomb_sum_cuda,
    "ungolomb_wsum": ungolomb_wsum_cuda,
    "pack2bit": pack2bit_cuda,
    "unpack2bit": unpack2bit_cuda,
    "qsgd8_pack8": qsgd8_pack8_cuda,
    "unpack8_sum": unpack8_sum_cuda,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
