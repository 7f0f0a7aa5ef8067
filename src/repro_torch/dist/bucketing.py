"""Bucketed uplink layout, the port of ``repro.dist.bucketing``: many
gradient leaves ride few big exchanges.

A ``BucketPlan`` is built once, when the step is built: every leaf's
wire-native payload is trimmed to whole canonical rows (LANES coordinates a
row) and laid out contiguously in fixed-capacity buckets, so one bucket rides
ONE exchange and the sublane-tile padding is paid once a bucket instead of
once a leaf. Row granularity keeps the packed formats exchange-legal:

  * ``pack2`` packs each canonical row on its own, so any whole-row slice of
    a payload is itself a valid pack2 stream: leaves start at any row
    (``align_rows=1``) and a bucket decodes in one pass, split per leaf
    after the decode;
  * ``pack8`` slices feed the decode-sum kernel per slot with that slot's
    scales, so slots align to ``SUBLANE_PAD`` rows (``align_rows=32``), each
    exactly its leaf's canonical view;
  * ``golomb`` slots are whole self-describing coded streams at their
    plan-time capacity rows (the wire's ``payload_rows``, given as
    ``build_bucket_plan``'s ``rows_fn``), each decoded as the per-leaf
    message (``align_rows=1``);
  * ``int8`` votes and ``f32`` decoded messages sum element by element, so
    rows are only the layout unit (``align_rows=1``).

The per-leaf compression is unchanged (seeds, counter base, budget and
scale), so a slot's payload is the per-leaf wire message byte for byte and
the bucketed exchange equals the per-leaf one. ``plan_ledger`` is the
bucketed twin of ``collectives.uplink_ledger``; ``streamed_plan_ledger`` the
streamed trainer's, which exchanges a layer's plan once a layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.dist import collectives
from repro_torch.kernels.common import LANES, SUBLANE_PAD

#: payload formats a bucket can carry: the wires' native formats and the
#: decoded float32 stream; ``golomb`` rows are capacity rows of the coded
#: stream, not coordinate rows
BUCKET_FORMATS = ("int8", "pack2", "golomb", "pack8", "f32")

#: bytes of one payload row in each format's buffer
ROW_BYTES = {"int8": LANES, "pack2": LANES // 4, "golomb": LANES // 4,
             "pack8": LANES, "f32": 4 * LANES}

#: dtype of the payload buffer in each format
ROW_DTYPE = {"int8": torch.int8, "pack2": torch.uint8, "golomb": torch.uint8,
             "pack8": torch.int8, "f32": torch.float32}

#: elements of one payload row in each format
ROW_WIDTH = {"int8": LANES, "pack2": LANES // 4, "golomb": LANES // 4,
             "pack8": LANES, "f32": LANES}


def format_align_rows(fmt: str) -> int:
    """Slot row alignment of a payload format: 32 for pack8, whose slots feed
    the decode-sum kernel per slot; 1 for every other format."""
    if fmt not in BUCKET_FORMATS:
        raise ValueError(f"unknown bucket format {fmt!r}; known: {BUCKET_FORMATS}")
    return SUBLANE_PAD if fmt == "pack8" else 1


def wire_bucket_format(mode: str, wire) -> str:
    """The payload format a wire mode's bucket carries: the wire's native
    format, or the decoded float32 stream for the ``decoded`` mode."""
    return "f32" if mode == "decoded" else wire.native_format


def leaf_rows(n: int, align_rows: int) -> int:
    """Payload rows of an n-coordinate leaf at an alignment: ceil to whole
    LANES rows, then to the alignment (at 32 this is ``canonical_rows(n)``)."""
    rows = -(-n // LANES)
    return -(-rows // align_rows) * align_rows


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One leaf's place in a bucket. ``index`` is the leaf's position in the
    flat leaf order the plan was built from (what seeds, quorum and EF are
    indexed by)."""

    index: int
    size: int
    shape: Tuple[int, ...]
    row_start: int
    rows: int


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One wire buffer: ``rows`` payload rows, the slots' rows and, for the
    packed formats, tail padding to the sublane tile."""

    slots: Tuple[LeafSlot, ...]
    rows: int

    @property
    def n_coords(self) -> int:
        return self.rows * LANES


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The static leaf-to-bucket layout of one exchange group (the whole tree
    in the simple trainer), built once when the step is built."""

    fmt: str
    align_rows: int
    buckets: Tuple[Bucket, ...]

    @property
    def n_slots(self) -> int:
        return sum(len(b.slots) for b in self.buckets)

    @property
    def total_rows(self) -> int:
        return sum(b.rows for b in self.buckets)

    def wire_nbytes(self) -> int:
        """Bytes of all payload buffers (one worker's copy), padding included."""
        return self.total_rows * ROW_BYTES[self.fmt]


def _tail_pad(rows: int, fmt: str) -> int:
    # the packed formats decode through sublane-tiled kernels; the psum
    # formats ship exactly the slot rows
    if fmt in ("pack2", "pack8"):
        return -(-rows // SUBLANE_PAD) * SUBLANE_PAD
    return rows


def build_bucket_plan(shapes: Sequence, fmt: str, *, bucket_bytes: Optional[int] = None,
                      rows_fn=None) -> BucketPlan:
    """Greedy in-order packing of ``shapes`` (leaf shapes, or objects with a
    ``shape``, in flat leaf order) into buckets of at most ``bucket_bytes``
    of payload (None: one bucket for the whole group). A leaf larger than
    the cap gets a bucket of its own; leaves are never split.

    ``rows_fn`` (n -> payload rows) sizes the variable-length golomb
    format's capacity slots (the wire's ``payload_rows``): required for
    ``fmt='golomb'`` and refused for every other format."""
    if (fmt == "golomb") != (rows_fn is not None):
        raise ValueError(
            "rows_fn is how the variable-length golomb format sizes its capacity slots: "
            "required for fmt='golomb' (pass the wire's payload_rows), invalid for the "
            "fixed-rate formats")
    align = format_align_rows(fmt)
    row_bytes = ROW_BYTES[fmt]
    cap_rows = None
    if bucket_bytes is not None:
        cap_rows = max(align, (int(bucket_bytes) // row_bytes // align) * align)
    buckets: List[Bucket] = []
    slots: List[LeafSlot] = []
    row = 0

    def flush():
        nonlocal slots, row
        if slots:
            buckets.append(Bucket(slots=tuple(slots), rows=_tail_pad(row, fmt)))
        slots, row = [], 0

    for i, s in enumerate(shapes):
        shape = tuple(int(d) for d in (s.shape if hasattr(s, "shape") else s))
        n = int(math.prod(shape)) if shape else 1
        rows = rows_fn(n) if rows_fn is not None else leaf_rows(n, align)
        if cap_rows is not None and slots and row + rows > cap_rows:
            flush()
        slots.append(LeafSlot(index=i, size=n, shape=shape, row_start=row, rows=rows))
        row += rows
        if cap_rows is not None and row >= cap_rows:
            flush()
    flush()
    return BucketPlan(fmt=fmt, align_rows=align, buckets=tuple(buckets))


# ---------------------------------------------------------------------------
# Payload assembly and splitting
# ---------------------------------------------------------------------------

def as_rows(values: torch.Tensor, fmt: str, rows: int) -> torch.Tensor:
    """One leaf's wire message as exactly ``rows`` payload rows (its slot).
    Packed messages arrive as canonical views and are trimmed (the dropped
    rows are the per-leaf sublane padding); golomb messages are already at
    their capacity rows; leaf-shaped messages are flattened and zero-padded.
    Element (r, c) keeps flat index r * LANES + c."""
    width = ROW_WIDTH[fmt]
    if fmt == "golomb":
        # a coded message is emitted at exactly its capacity rows, the rule
        # that sized the slot: a mismatch means encoder and plan disagree
        assert values.dim() == 2 and tuple(values.shape) == (rows, width), \
            (tuple(values.shape), rows, width)
        return values
    if fmt in ("pack2", "pack8"):
        assert values.dim() == 2 and values.shape[1] == width, tuple(values.shape)
        assert values.shape[0] >= rows, (tuple(values.shape), rows)
        return values[:rows]
    flat = values.reshape(-1).to(ROW_DTYPE[fmt])
    assert flat.shape[0] <= rows * width, (tuple(flat.shape), rows)
    padded = torch.zeros(rows * width, dtype=ROW_DTYPE[fmt], device=values.device)
    padded[:flat.shape[0]] = flat
    return padded.reshape(rows, width)


def assemble_bucket(payloads: Sequence[torch.Tensor], bucket: Bucket,
                    fmt: str) -> torch.Tensor:
    """Slot payloads (aligned with ``bucket.slots``) -> one contiguous
    (bucket.rows, width) buffer, tail rows zero."""
    parts = list(payloads)
    assert len(parts) == len(bucket.slots)
    used = sum(s.rows for s in bucket.slots)
    if bucket.rows > used:
        parts.append(torch.zeros((bucket.rows - used, ROW_WIDTH[fmt]), dtype=ROW_DTYPE[fmt],
                                 device=parts[0].device))
    return torch.cat(parts, dim=0)


def split_bucket(agg: torch.Tensor, bucket: Bucket) -> List[torch.Tensor]:
    """One bucket's aggregated payload (row-shaped or flat) -> per-leaf views
    in the leaves' shapes, aligned with ``bucket.slots``."""
    flat = agg.reshape(-1)
    return [flat[s.row_start * LANES:s.row_start * LANES + s.size].reshape(s.shape)
            for s in bucket.slots]


# ---------------------------------------------------------------------------
# Byte ledger: the bucketed twin of collectives.uplink_ledger
# ---------------------------------------------------------------------------

def plan_ledger(mode: str, wire, plan: BucketPlan, *,
                share_linf: bool = False) -> Tuple[float, float]:
    """(payload bytes, scalar bytes) one application of ``plan`` bills to the
    per-device uplink: each bucket's ``uplink_ledger_bucket`` (one bucket,
    one exchange, times its ring chunks), and for a shared magnitude ONE
    vector max over all the plan's slots (payload from two slots on, as
    JAX's census splits it)."""
    payload = scalar = 0.0
    for b in plan.buckets:
        p, s = collectives.uplink_ledger_bucket(mode, wire, b.n_coords, len(b.slots),
                                                rows=b.rows,
                                                ring_chunks=wire.bucket_ring_chunks(b))
        payload += p
        scalar += s
    if share_linf:
        n = plan.n_slots
        bytes_ = collectives.allreduce_scalar_bytes(wire.n_workers) * n
        if n >= 2:
            payload += bytes_
        else:
            scalar += bytes_
    return payload, scalar


def plan_gather_hbm_bytes(mode: str, wire, plan: BucketPlan) -> float:
    """Peak device memory of the gathered payload over the plan's bucket
    exchanges: the largest bucket's (they run one at a time); 0.0 for the
    decoded mode, whose sum never holds a gathered tensor."""
    if mode == "decoded":
        return 0.0
    return max((wire.bucket_gather_hbm_bytes(b) for b in plan.buckets), default=0.0)


def streamed_plan_ledger(mode: str, wire, block_plan: BucketPlan, outer_plan: BucketPlan,
                         n_repeats: int, *, share_linf: bool = False) -> Tuple[float, float]:
    """(payload, scalar) per-device uplink bytes of one bucketed streamed
    step, JAX's definition. The double-buffered backward exchanges the
    pending layer's buckets each iteration: it primes with one zero bucket
    and drains the last pending one after the loop, so each block bucket
    rides the wire ``n_repeats + 1`` times a step. The shared L-inf vector
    max runs at compress time, once a real layer (``n_repeats``) and once
    for the outer group."""
    bp, bs = plan_ledger(mode, wire, block_plan)
    op, osc = plan_ledger(mode, wire, outer_plan, share_linf=share_linf)
    payload = (n_repeats + 1) * bp + op
    scalar = (n_repeats + 1) * bs + osc
    if share_linf:
        n = block_plan.n_slots
        bytes_ = collectives.allreduce_scalar_bytes(wire.n_workers) * n
        if n >= 2:
            payload += n_repeats * bytes_
        else:
            scalar += n_repeats * bytes_
    return payload, scalar
