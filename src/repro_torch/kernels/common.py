"""Shared plumbing for the port's kernels and their plain versions.

The JAX package runs every kernel on a canonical ``(rows, LANES)`` view with
rows padded to ``SUBLANE_PAD``; the logical coordinate of element (r, c) is
``r * LANES + c``, its index in the flat tensor. The int8 kernels work on the
flat tensor with a masked tail instead, which gives the same counter stream
without the pad pass. The 2-bit packed wire keeps the view: a message is the
``(canonical_rows(n), PACKED_WIDTH)`` uint8 packing of it (``kernels/pack2bit``).
"""

from __future__ import annotations

import math

import torch

LANES = 512            # lane width of the canonical view (4 * 128)
SUBLANE_PAD = 32       # row padding multiple (int8 sublane tile)
DEFAULT_BLOCK_ROWS = 256
PACKED_WIDTH = LANES // 4   # bytes of a packed canonical row (2 bits a coordinate)


def canonical_rows(n: int, lanes: int = LANES, row_pad: int = SUBLANE_PAD) -> int:
    """Rows of the canonical view of an n-element stream: ceil to full lanes,
    then to the sublane tile."""
    rows = -(-n // lanes)
    return -(-rows // row_pad) * row_pad


def packed_shape(n: int) -> tuple:
    """Shape of the 2-bit packed canonical view of an n-element stream."""
    return (canonical_rows(n), PACKED_WIDTH)


def encode2bit(t: torch.Tensor) -> torch.Tensor:
    """int8 ternary {-1, 0, +1} -> 2-bit code uint8 {2, 0, 1}: the packed
    wire's codebook."""
    return torch.where(t < 0, torch.full((), 2, dtype=torch.uint8, device=t.device),
                       t.to(torch.uint8))


def to_2d(flat: torch.Tensor, lanes: int = LANES, row_pad: int = SUBLANE_PAD):
    """Zero-pad a flat tensor to its (rows, lanes) view; returns (view, n)."""
    if flat.dim() != 1:
        raise ValueError(f"to_2d takes a flat tensor, got shape {tuple(flat.shape)}")
    n = flat.shape[0]
    rows = canonical_rows(n, lanes, row_pad)
    padded = torch.zeros(rows * lanes, dtype=flat.dtype, device=flat.device)
    padded[:n] = flat
    return padded.reshape(rows, lanes), n


def from_2d(view: torch.Tensor, n: int, shape, dtype=None) -> torch.Tensor:
    out = view.reshape(-1)[:n].reshape(shape)
    return out.to(dtype) if dtype is not None else out


def decode_sum_out(out, shape, default: torch.dtype, dtypes, accumulate: bool,
                   device) -> torch.Tensor:
    """The ``shape`` output view of a decode-sum (the sums' (rows, lanes)):
    ``out`` (a contiguous tensor of as many elements of one of ``dtypes``, on
    ``device``) viewed so, or a new uninitialized ``default`` tensor when it
    is None, which ``accumulate`` cannot add into."""
    shape = tuple(shape)
    if out is None:
        if accumulate:
            raise ValueError("accumulate=True adds into out: pass the output to add into")
        return torch.empty(shape, dtype=default, device=device)
    if out.dtype not in dtypes:
        raise TypeError(f"out must have dtype in {dtypes}, got {out.dtype}")
    if (out.numel() != math.prod(shape) or not out.is_contiguous()
            or out.device != torch.device(device)):
        raise ValueError(f"out must be a contiguous tensor of {shape} elements on {device}, "
                         f"got shape {tuple(out.shape)} on {out.device}")
    return out.view(shape)


def block_rows_for(rows: int, want: int = DEFAULT_BLOCK_ROWS) -> int:
    """Largest divisor of ``rows`` that is <= want and a multiple of SUBLANE_PAD."""
    want = min(want, rows)
    want = max(SUBLANE_PAD, (want // SUBLANE_PAD) * SUBLANE_PAD)
    while rows % want:
        want -= SUBLANE_PAD
    return max(want, SUBLANE_PAD)


def jnp_sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign`` semantics: +1/-1 for nonzero x, x itself for +-0.0 and NaN.
    ``torch.sign`` maps -0.0 to +0.0 and NaN to 0, which changes the bits of
    the EF server's ``scale * sign(acc)`` and ``acc - out``."""
    if not x.is_floating_point():
        return torch.sign(x)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def device_tensor(x, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``x`` (a number, sequence or tensor) as a ``dtype`` tensor on ``like``'s
    device. A Python number becomes a fill on the device, not a copy from the
    host, so no call on the round's path waits for the card; a sequence is
    copied."""
    if isinstance(x, torch.Tensor):
        return x.to(like.device, dtype)
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=dtype, device=like.device)
    return torch.as_tensor(x, dtype=dtype, device=like.device)


def check_cuda_tensor(name: str, t: torch.Tensor, dtypes) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must have dtype in {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def map_args(counter_base, counter_map) -> tuple:
    """A slice's counter map ``(run, leaf_run, offset)`` as the kernels'
    launch arguments: (counter_base + offset, run, leaf_run - run), both
    uint32 values wrapped as the unsharded counter wraps."""
    run, leaf_run, offset = (int(v) for v in counter_map)
    if run < 1 or leaf_run < run or not 0 <= offset <= leaf_run - run:
        raise ValueError(f"counter map {counter_map!r}: need 1 <= run <= leaf_run and "
                         f"0 <= offset <= leaf_run - run")
    return (int(counter_base) + offset) & 0xFFFFFFFF, run, (leaf_run - run) & 0xFFFFFFFF


def counter_index(n: int, counter_base, device, counter_map=None) -> torch.Tensor:
    """int64 counters of a message's n flat coordinates: ``counter_base + j``,
    or for a model rank's slice of a leaf (``counter_map = (run, leaf_run,
    offset)``: the slice is rows of ``run`` contiguous coordinates of the
    leaf's rows of ``leaf_run``, ``offset`` into each) the whole leaf's
    counter at the same coordinate, ``counter_base + (j // run) * leaf_run +
    offset + j % run``. ``prng`` masks them to 32 bits, as the kernels wrap."""
    j = torch.arange(n, dtype=torch.int64, device=device)
    if counter_map is None:
        return j + int(counter_base)
    base, run, skip = map_args(counter_base, counter_map)
    return j + base + torch.div(j, run, rounding_mode="floor") * skip
