"""Worker-axis collectives for the vote exchange (Algorithm 1 step 3), the
port of ``repro.dist.collectives``: the ``VoteWire`` family every trainer
speaks, and the elastic-participation contract it carries.

The paper's M workers are a ``WorkerGroup``: a leading worker dimension of
``local`` workers in this process, times the processes of an optional
``torch.distributed`` group (gloo on the CPU, NCCL with one rank per card),
in flat worker-index order, rank-major, as ``worker_index`` orders them. On
one card the group is one process holding all M workers; NCCL refuses two
ranks on one device, and a 4B-parameter replica per rank would not fit M
times anyway. Where JAX runs collectives over named mesh axes:

  psum       a sum over the local dimension, then ``all_reduce``;
  all_gather ``all_gather_into_tensor`` of the local stack (rank-major);
  pmax       a max over the local dimension, then ``all_reduce(MAX)``.

Integer sums are exact in any order. Float sums (the weighted psum wires,
the decoded wire, protocol scalars) are gathered first and added in worker
order, because the reduction order of NCCL and gloo is unspecified.

Three wire-equivalent vote wires return the same per-coordinate vote total:

- ``VoteWire`` (``psum``): one integer sum of int8 votes;
- ``HierVoteWire`` (``hier``): int8-narrow within the inner axis, widened
  across the outer one;
- ``PackedVoteWire`` (``allgather_packed``): all-gather of 2-bit packed
  messages and the fused decode-sum kernel (``unpack2bit_sum``, or
  ``unpack2bit_wsum`` under elastic participation); M x d/4 bytes a leaf;
- ``GolombWire`` (``allgather_packed`` with wire format ``golomb``):
  all-gather of Golomb/Rice entropy-coded messages at a static plan-time
  capacity (``kernels/golomb``) and the fused decode-sum kernel
  (``ungolomb_sum``, or ``ungolomb_wsum``); about (2 + b) p d / 8 bytes a
  message at plan fraction p.

Non-ternary 8-bit payloads (qsgd8's sign*level stream, wire format
``pack8``) ride ``Pack8Wire``: an all-gather of 1 B a coordinate plus each
worker's float32 decode scale, dequantized into the mean server's float sum
by the fused decode-sum kernel (``unpack8_sum``) in worker order, so it
equals the decoded psum bit for bit. There is no psum variant: a psum cannot
add levels quantized against different norms.

Each wire knows its native message format, how to mask, count and exchange
messages in it, and its per-device byte ledger (``wire_bytes``), computed
from the real buffer sizes. ``exchange_bucket`` exchanges one bucket of many
leaves' messages at once (``dist.bucketing``), each slot equal to the
per-leaf exchange.

Ring-pipelined gather (``ring_chunk_rows``, the gather wires only): instead
of holding all M messages, the payload is cut into row chunks and each chunk
goes round the worker ring, every arriving message decoded at M = 1 by the
same decode-sum kernel (on the 2-bit and pack8 wires added in place into the
chunk's slice of the output, one launch a hop; on golomb decoded, then
added), so the gathered payload held at once is about two chunks instead of
M messages; the bytes on the fabric are the same (``gather_hbm_bytes`` is
the residency ledger). In one process a hop is a step to the next local
worker's message; across processes it sends the process's chunk stack to
rank + 1 and receives rank - 1's (``ring_permute``, the port's only
point-to-point call). The sum runs
in JAX's ring order for the first worker w0 = rank * local: w0, w0 - 1,
..., w0 - M + 1 (mod M). Integer sums (pack2, golomb) equal the monolithic
gather's in any order; pack8's float sums and the weighted sums of weights
that are not dyadic round in that order, so they can differ from the
monolithic sum in the last bit, and across processes, as JAX's devices do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.common import LANES, PACKED_WIDTH, SUBLANE_PAD, canonical_rows, from_2d
from repro_torch.kernels.golomb.ops import ungolomb_sum_op, ungolomb_wsum_op
from repro_torch.kernels.golomb.ref import (ROW_BYTES, golomb_nbytes, golomb_rows,
                                            ungolomb_sum_ref, ungolomb_wsum_ref)
from repro_torch.kernels.pack2bit.ops import unpack2bit_sum_op, unpack2bit_wsum_op
from repro_torch.kernels.pack2bit.ref import unpack2bit_sum_ref, unpack2bit_wsum_ref
from repro_torch.kernels.pack8.ops import unpack8_sum_op
from repro_torch.kernels.pack8.ref import unpack8_sum_ref

VOTE_IMPLS = ("psum", "hier", "allgather_packed")


@dataclasses.dataclass(frozen=True)
class ParticipationSpec:
    """Elastic participation: per-worker vote weights (FedCom-style data-volume
    weighting), a quorum expressed as a FRACTION of realized participation,
    and a per-round report-dropout rate (crashes, stragglers past the round
    deadline). A ``VoteWire`` carries it into the weighted exchange.

    With a spec, the round's weighted vote is ``sum_m w_m * votes_m`` with the
    realized participation ``W = sum_{reporting} w_m``, and the server
    deadband is ``|sum w_m sign_m| >= q_frac * W`` instead of a fixed integer
    quorum. ``weights=None`` means uniform 1.0; ``q_frac=None`` derives the
    fraction from the integer quorum (``resolve_q_frac``). Validation is
    loud and happens at build time."""

    weights: Optional[Tuple[float, ...]] = None
    q_frac: Optional[float] = None
    dropout: float = 0.0

    def __post_init__(self):
        if self.weights is not None:
            w = tuple(float(x) for x in self.weights)
            if not w or any(not (x > 0.0) or not (x < float("inf")) for x in w):
                raise ValueError(
                    f"participation weights must be positive finite floats (a zero or "
                    f"negative weight is a permanently dead worker: shrink the fleet "
                    f"instead), got {self.weights!r}")
            object.__setattr__(self, "weights", w)
        if self.q_frac is not None:
            q = float(self.q_frac)
            if not (0.0 < q <= 1.0):
                raise ValueError(
                    f"quorum fraction must be in (0, 1]: it is the share of realized "
                    f"participation the vote magnitude must clear, got {self.q_frac!r}")
        d = float(self.dropout)
        if not (0.0 <= d < 1.0):
            raise ValueError(
                f"report dropout must be in [0, 1) (1.0 would drop every report every "
                f"round), got {self.dropout!r}")

    @property
    def is_uniform(self) -> bool:
        return self.weights is None

    def weights_array(self, n_workers: int, device=None) -> torch.Tensor:
        """(M,) float32 per-worker weights on ``device`` (uniform 1.0 when
        unset), checked against the worker count."""
        if self.weights is None:
            return torch.ones((n_workers,), dtype=torch.float32, device=device)
        if len(self.weights) != n_workers:
            raise ValueError(f"participation weights cover {len(self.weights)} workers "
                             f"but the fleet has {n_workers}")
        return torch.tensor(self.weights, dtype=torch.float32, device=device)

    def weight_of(self, widx, n_workers: int, device=None) -> torch.Tensor:
        """Worker ``widx``'s static weight as a float32 tensor."""
        if self.weights is None:
            return torch.ones((), dtype=torch.float32, device=device)
        return self.weights_array(n_workers, device)[widx]

    def resolve_q_frac(self, quorum: int, n_workers: int) -> float:
        """The explicit ``q_frac``, else the integer quorum as ``quorum / M``:
        at full uniform participation (W = M) the weighted deadband
        ``|v| >= q_frac * W`` is then the integer ``|v| >= quorum``."""
        if self.q_frac is not None:
            return float(self.q_frac)
        q = int(quorum)
        if not (1 <= q <= n_workers):
            raise ValueError(f"cannot derive a quorum fraction: integer quorum {quorum!r} "
                             f"is outside [1, M={n_workers}]")
        return q / float(n_workers)


# ---------------------------------------------------------------------------
# The collective recorder (the counterpart of JAX's ``collective_census``)
# ---------------------------------------------------------------------------

#: the byte model of each recorded collective (per device, ring collectives):
#: all-reduce 2(M - 1)/M x in, all-gather (M - 1) x in, and a ring's hop loop
#: (one ``ppermute`` record a chunk) (M - 1) x chunk; the VoteWire ledgers
#: bill the same models
ALL_REDUCE_PRIMS = ("psum", "pmax")
MODELED_PRIMS = ALL_REDUCE_PRIMS + ("all_gather", "ppermute")


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective call as one worker's operand: ``in_elems`` and
    ``in_bytes`` a worker, over ``n_workers`` = M. ``primitive`` is the
    collective of the JAX program it stands for, which the ledger bills:
    ``psum`` also for a float sum the port gathers and adds in worker order
    (``ordered_psum``: bit for bit, where an all-reduce's order is
    unspecified). ``moved`` is the collective that really runs between
    processes when it differs (that gather, ``all_gather``: (M - 1) x in
    where the ledger bills 2(M - 1)/M x in). ``role``: ``wire`` the uplink
    ledger bills it, ``scalar`` a
    protocol or metric scalar it does not (loss, nnz, counts, the EF L1
    partials), ``param`` the streamed trainer's FSDP parameter gathers.
    ``zero_workers`` holds, for an integer payload of two elements or more,
    whether each of the process's workers (flat index ``first_worker + j``)
    shipped all zeros. ``model_ranks``: under tensor parallelism, the model
    ranks whose devices this call stands for (one for a slice's exchange,
    every local rank for a replicated leaf's, which one process makes once);
    role ``tp`` is a reduction over 'model' itself."""

    primitive: str
    in_elems: int
    in_bytes: int
    dtype: str
    n_workers: int
    role: str = "wire"
    first_worker: int = 0
    zero_workers: tuple = ()
    moved: str = ""
    model_ranks: tuple = ()   # the model ranks whose devices make the call (): all

    def _bytes(self, primitive: str) -> float:
        m = self.n_workers
        if m <= 1:
            return 0.0
        if primitive in ALL_REDUCE_PRIMS:
            return 2.0 * (m - 1) / m * self.in_bytes
        if primitive in ("all_gather", "ppermute"):
            return float((m - 1) * self.in_bytes)
        raise ValueError(f"no byte model for {primitive!r}")

    def ring_bytes(self) -> float:
        """Per-device bytes the ledger bills, under the ring model (JAX's
        ``CollectiveRecord.ring_bytes``); 0 for one worker."""
        return self._bytes(self.primitive)

    def moved_bytes(self) -> float:
        """Per-device bytes a group of M processes really moves: the
        ``moved`` collective's, else ``ring_bytes``."""
        return self._bytes(self.moved or self.primitive)


@dataclasses.dataclass
class Census:
    """Every collective recorded inside one ``record_collectives`` block.
    ``unknown`` holds records whose primitive has no byte model: excluded
    from every sum, and a blocking finding of the census rule."""

    records: list = dataclasses.field(default_factory=list)
    unknown: list = dataclasses.field(default_factory=list)

    def add(self, rec: CollectiveRecord) -> None:
        (self.records if rec.primitive in MODELED_PRIMS else self.unknown).append(rec)

    def counts(self) -> dict:
        out = {}
        for r in self.records:
            out[r.primitive] = out.get(r.primitive, 0) + 1
        return out

    def _select(self, *, payload: bool, roles=("wire",)):
        return [r for r in self.records if r.role in roles
                and ((r.in_elems >= 2) if payload else (r.in_elems <= 1))]

    def payload_bytes(self) -> float:
        """Array payloads (two elements or more) the uplink ledger bills."""
        return sum(r.ring_bytes() for r in self._select(payload=True))

    def scalar_bytes(self) -> float:
        """Scalars (one element) the ledger bills: decode scales, weights,
        the shared L-inf max."""
        return sum(r.ring_bytes() for r in self._select(payload=False))

    def payload_count(self) -> int:
        return len(self._select(payload=True))

    def moved_bytes(self) -> float:
        """What the billed records (payloads and scalars) move between
        processes: above ``payload_bytes() + scalar_bytes()`` by the
        worker-order gathers billed as all-reduces."""
        return sum(r.moved_bytes() for r in self.records if r.role == "wire")

    def scalar_count(self) -> int:
        return len(self._select(payload=False, roles=("wire", "scalar")))

    def for_model_rank(self, rank: int) -> "Census":
        """The calls one device of model rank ``rank`` makes: its slices'
        exchanges and the replicated leaves', without the 'model' axis's own
        reductions (role ``tp``)."""
        keep = [r for r in self.records if r.role != "tp"
                and (not r.model_ranks or rank in r.model_ranks)]
        return Census(records=keep, unknown=list(self.unknown))

    def tp_records(self) -> list:
        return [r for r in self.records if r.role == "tp"]


_CENSUSES: list = []   # the open record_collectives blocks, innermost last
_MODEL_RANKS: list = [()]   # the model ranks the wire calls stand for, innermost last


@contextlib.contextmanager
def for_model_ranks(ranks):
    """Recorded wire calls inside the block stand for the devices of these
    model ranks (``CollectiveRecord.model_ranks``)."""
    _MODEL_RANKS.append(tuple(ranks))
    try:
        yield
    finally:
        _MODEL_RANKS.pop()


@contextlib.contextmanager
def record_collectives():
    """Record every collective wrapper's call inside the block into the
    yielded ``Census``: ``WorkerGroup.gather`` and ``all_reduce``, a ring's
    hop loop (``_ring_order``, once a chunk and side channel: the loop of
    M - 1 hops that ``ring_permute`` makes between processes) and
    ``fsdp_all_gather``, at the wrapper's entry, also in one process where
    nothing moves. Outside a block the wrappers do no extra work."""
    census = Census()
    _CENSUSES.append(census)
    try:
        yield census
    finally:
        _CENSUSES.remove(census)


def _record(primitive: str, x, group: "WorkerGroup", *, role: str = "wire",
            stacked: bool = True, moved: str = "") -> None:
    """Record one call into every open census. ``x`` is the (local, ...)
    stack of the process's workers' operands, or a sequence of them, or,
    with ``stacked=False``, one operand (a per-process partial). An integer
    payload of two elements or more a worker notes which workers' are all
    zeros."""
    local = group.local
    if stacked:
        elems = sum(t.numel() for t in x) // local if isinstance(x, (list, tuple)) \
            else x.numel() // local
    else:
        elems = x.numel()
    t0 = x[0] if isinstance(x, (list, tuple)) else x
    zeros = ()
    if stacked and role == "wire" and elems >= 2 and not t0.is_floating_point():
        zeros = tuple(not bool(torch.count_nonzero(x[j])) for j in range(local))
    rec = CollectiveRecord(primitive=primitive, in_elems=elems,
                           in_bytes=elems * t0.element_size(),
                           dtype=str(t0.dtype).split(".")[-1], n_workers=group.n_workers,
                           role=role, first_worker=group.rank * local,
                           zero_workers=zeros, moved=moved, model_ranks=_MODEL_RANKS[-1])
    for census in _CENSUSES:
        census.add(rec)


# ---------------------------------------------------------------------------
# The worker group
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class WorkerGroup:
    """The M workers: named axes with their global sizes (``sizes``, the
    mesh's worker axes, row-major), held as ``local`` workers in each of the
    ``world`` processes of ``group``; this process holds flat worker indices
    ``rank * local .. rank * local + local - 1``. ``group`` None is one
    process holding every worker."""

    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    group: Optional[object] = None
    rank: int = 0
    world: int = 1
    model: Optional["ModelGroup"] = None   # the 'model' axis (None: no tensor parallelism)

    @property
    def model_size(self) -> int:
        """T, the 'model' axis's size (1 without tensor parallelism)."""
        return self.model.size if self.model is not None else 1

    def __post_init__(self):
        if len(self.axes) != len(self.sizes) or not self.axes:
            raise ValueError(f"worker axes {self.axes!r} and sizes {self.sizes!r} differ")
        if self.n_workers % self.world:
            raise ValueError(f"{self.n_workers} workers do not split over {self.world} "
                             f"processes")

    @property
    def n_workers(self) -> int:
        return math.prod(self.sizes)

    @property
    def local(self) -> int:
        return self.n_workers // self.world

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(local, ...) -> (M, ...) in flat worker order: the all-gather."""
        if _CENSUSES:
            _record("all_gather", x, self)
        return self._gather(x)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        if self.group is None or self.world == 1:
            return x
        out = torch.empty((self.n_workers,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor, op=None) -> torch.Tensor:
        """Reduce a per-process partial over the processes (integer sums and
        maxima only: exact in any order)."""
        if _CENSUSES:
            maximum = op is not None and op == dist.ReduceOp.MAX
            _record("pmax" if maximum else "psum", x, self, stacked=False)
        if self.group is not None and self.world > 1:
            dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=self.group)
        return x


@dataclasses.dataclass(frozen=True, eq=False)
class ModelGroup:
    """The T model ranks of the 'model' (tensor-parallel) axis that share one
    worker. This process holds ``local`` consecutive ranks from ``offset``
    (a leading dimension, as the workers are); the other ranks live in the
    ``world`` processes of ``group`` (None: all here), this one being its
    ``rank``-th. The devices of a mesh are row-major over (worker axes...,
    'model'), JAX's mesh order, so a process holds either whole workers
    (every rank, ``group`` None) or some ranks of one worker.

    One reduction: the ORDERED all-reduce ``tp_sum``: the partials of all T
    ranks are gathered, then added in rank order, so one process and several
    give the same bits."""

    size: int
    offset: int = 0
    local: int = 0
    group: Optional[object] = None
    rank: int = 0
    world: int = 1

    def __post_init__(self):
        if self.local == 0:
            object.__setattr__(self, "local", self.size)
        if self.size < 1 or self.local * self.world != self.size:
            raise ValueError(f"{self.size} model ranks do not split into {self.world} "
                             f"processes of {self.local}")

    @property
    def ranks(self) -> range:
        """This process's model ranks."""
        return range(self.offset, self.offset + self.local)


def _record_tp(primitive: str, parts: Sequence[torch.Tensor], mg: ModelGroup) -> None:
    """Record one 'model'-axis reduction (role ``tp``: neither the uplink
    ledger nor a protocol scalar): one rank's operand, over T ranks."""
    t0 = parts[0]
    rec = CollectiveRecord(primitive=primitive, in_elems=t0.numel(),
                           in_bytes=t0.numel() * t0.element_size(),
                           dtype=str(t0.dtype).split(".")[-1], n_workers=mg.size, role="tp",
                           first_worker=mg.offset,
                           moved="all_gather" if primitive == "psum" else "")
    for census in _CENSUSES:
        census.add(rec)


def tp_gather(parts: Sequence[torch.Tensor], mg: ModelGroup) -> list:
    """This process's ranks' tensors (one a local rank, equal shapes) -> all
    T ranks' in rank order: the 'model' axis's all-gather."""
    if mg.group is None or mg.world == 1:
        return list(parts)
    x = torch.stack(list(parts)).contiguous()
    out = torch.empty((mg.size,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mg.group)
    return list(out.unbind(0))


def tp_sum(parts: Sequence[torch.Tensor], mg: ModelGroup) -> torch.Tensor:
    """The ordered all-reduce over 'model': ``parts`` holds one partial a
    local rank; every rank's is gathered, then they are added in rank order
    (((p0 + p1) + p2) + ...), the same bits in any process layout. Recorded
    as a ``psum`` of role ``tp``."""
    if _CENSUSES:
        _record_tp("psum", parts, mg)
    every = tp_gather(parts, mg)
    acc = every[0]
    for x in every[1:]:
        acc = acc + x
    return acc


def tp_max(parts: Sequence[torch.Tensor], mg: ModelGroup) -> torch.Tensor:
    """The elementwise max over 'model' of one partial a local rank (exact in
    any order). Recorded as a ``pmax`` of role ``tp``."""
    if _CENSUSES:
        _record_tp("pmax", parts, mg)
    local = torch.stack(list(parts)).amax(dim=0)
    if mg.group is not None and mg.world > 1:
        dist.all_reduce(local, op=dist.ReduceOp.MAX, group=mg.group)
    return local


def tp_all_gather(parts: Sequence[torch.Tensor], mg: ModelGroup, dim: int) -> torch.Tensor:
    """Each local rank's slice of a leaf along ``dim`` -> the whole leaf,
    slices in rank order (a parameter gather: recorded as an ``all_gather``
    of role ``tp``)."""
    if _CENSUSES:
        _record_tp("all_gather", parts, mg)
    return torch.cat(tp_gather(parts, mg), dim=dim)


def worker_count(group: WorkerGroup) -> int:
    """M = the product of the worker-axis sizes."""
    return group.n_workers


def worker_index(group: WorkerGroup, device=None) -> torch.Tensor:
    """The flat indices of this process's workers: an int64 (local,) tensor."""
    start = group.rank * group.local
    return torch.arange(start, start + group.local, dtype=torch.int64, device=device)


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 as a left fold in index order: ((x0 + x1) + x2) + ...,
    the association a float sum over workers keeps in the port."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def _sum_dtype(n_workers: int) -> torch.dtype:
    """Smallest int dtype holding ternary-vote sums in [-M, M]: the psum
    payload dtype is the wire format, so it is not widened beyond need."""
    if n_workers <= 127:
        return torch.int8
    if n_workers <= 32767:
        return torch.int16
    return torch.int32


def packed_nbytes(n_coords: int) -> int:
    """Bytes of one worker's 2-bit packed message for an n-coordinate leaf:
    the canonical view padded to the sublane tile, padded rows included."""
    return canonical_rows(n_coords) * PACKED_WIDTH


def packed8_nbytes(n_coords: int) -> int:
    """Bytes of one worker's pack8 message for an n-coordinate leaf: the
    canonical (rows, 512) int8 view, padded rows included."""
    return canonical_rows(n_coords) * LANES


def golomb_payload_nbytes(n_coords: int, p: float, leaf_n: Optional[int] = None) -> int:
    """Bytes of one worker's entropy-coded golomb message for an n-coordinate
    leaf (or a slice of an ``leaf_n``-coordinate one) at plan fraction p: the
    static capacity, padding included."""
    return golomb_nbytes(n_coords, p, leaf_n)


def _golomb_decode_sum(gathered: torch.Tensor, size: int, shape, *, p: float,
                       backend: Optional[str] = None) -> torch.Tensor:
    """(M, rows, 128) gathered coded messages -> int32 vote sum of ``shape``:
    the plain version for ``backend="torch"``, else the op (the kernel on the
    card)."""
    if backend == "torch":
        return ungolomb_sum_ref(gathered, size, shape, p=p)
    return ungolomb_sum_op(gathered, size, shape, p=p)


def _golomb_decode_wsum(gathered: torch.Tensor, weights: torch.Tensor, size: int, shape, *,
                        p: float, backend: Optional[str] = None) -> torch.Tensor:
    """The weighted twin of ``_golomb_decode_sum``: float32
    ``sum_m w_m * votes_m`` of ``shape``, in worker order."""
    if backend == "torch":
        return ungolomb_wsum_ref(gathered, weights, size, shape, p=p)
    return ungolomb_wsum_op(gathered, weights, size, shape, p=p)


def vote_psum(votes: torch.Tensor, group: WorkerGroup, n_workers: int) -> torch.Tensor:
    """Integer sum over the workers of a (local, ...) stack of ternary votes,
    in the narrowest dtype that holds it."""
    sd = _sum_dtype(int(n_workers))
    return group.all_reduce(torch.sum(votes.to(sd), dim=0, dtype=sd))


def ordered_psum(x: torch.Tensor, group: WorkerGroup, *, role: str = "wire",
                 fold=ordered_sum) -> torch.Tensor:
    """The all-reduce of a float (local, ...) stack, bit for bit in any
    process layout: gathered in worker order, then added up by ``fold``
    (``ordered_sum``, or the hier wire's two-level fold). The recorder
    bills it as the psum of the JAX program it stands for and notes the
    all-gather that moves; ``role`` as in ``CollectiveRecord``."""
    if _CENSUSES:
        _record("psum", x, group, role=role, moved="all_gather")
    return fold(group._gather(x))


def scalar_psum(x: torch.Tensor, group: WorkerGroup) -> torch.Tensor:
    """All-reduce of O(1) protocol and metric scalars (loss, nnz,
    participation counts): ``x`` holds one value per local worker; gathered,
    then summed in worker order."""
    return ordered_psum(x.reshape(group.local, -1), group, role="scalar").reshape(x.shape[1:])


def fsdp_all_gather(leaf: torch.Tensor, group: WorkerGroup, axis: int) -> torch.Tensor:
    """The streamed trainer's parameter gather: each process's slice of a
    leaf along ``axis`` -> the whole leaf, the slices in rank order. With one
    process the slice is the leaf, returned as it is (no copy). The only raw
    collective for parameters: it moves weights, not gradient messages, so
    the wires' ledger does not bill it."""
    if _CENSUSES:
        _record("all_gather", leaf, group, role="param")
    if group.group is None or group.world == 1:
        return leaf
    x = leaf.movedim(axis, 0).contiguous()
    out = torch.empty((group.world * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=group.group)
    return out.movedim(0, axis)


def worker_shared_linf(gs: Sequence[torch.Tensor], group: WorkerGroup,
                       mask=None) -> torch.Tensor:
    """max_m ||g_m||_inf over the workers (TernGrad's magnitude sharing and
    the ``linf_share`` budget): ``gs`` holds this process's workers' copies of
    one leaf, ``mask`` (local,) bool drops non-participants from the max."""
    local = torch.stack([torch.amax(torch.abs(g.to(torch.float32))) for g in gs])
    if mask is not None:
        local = torch.where(mask, local, torch.zeros((), device=local.device))
    return group.all_reduce(torch.amax(local), op=dist.ReduceOp.MAX)


def worker_shared_linf_many(sources: Sequence[Sequence[torch.Tensor]], group: WorkerGroup,
                            mask=None) -> torch.Tensor:
    """The vectorized ``worker_shared_linf`` of the bucketed path: ONE (L,)
    max for L leaves. ``sources[j]`` holds local worker j's L leaves; entry
    i equals ``worker_shared_linf([s[i] for s in sources], ...)`` bit for bit
    (a max is exact)."""
    local = torch.stack([torch.stack([torch.amax(torch.abs(g.to(torch.float32))) for g in src])
                         for src in sources])
    if mask is not None:
        local = torch.where(mask[:, None], local, torch.zeros((), device=local.device))
    return group.all_reduce(torch.amax(local, dim=0), op=dist.ReduceOp.MAX)


def decoded_message(values: torch.Tensor, scale, mask, *, is_ternary: bool):
    """One worker's ``decoded``-mode message: decoded locally (values *
    scale), zeroed for a non-participant. Returns (float32 message, masked
    nnz): ternary messages count |symbols|, float payloads nonzero decoded
    coordinates."""
    zero = torch.zeros((), dtype=torch.float32, device=values.device)
    dec = torch.where(mask, values.to(torch.float32) * scale, zero)
    if is_ternary:
        nnz = torch.where(mask, torch.count_nonzero(values).to(torch.float32), zero)
    else:
        nnz = torch.count_nonzero(dec).to(torch.float32)
    return dec, nnz


def decoded_exchange(values: torch.Tensor, scale, mask, group: WorkerGroup, *,
                     is_ternary: bool):
    """The ``decoded`` wire mode: decode each local worker's message (a
    (local, ...) stack, ``scale`` and ``mask`` one entry a worker), zero
    non-participants, and sum the float32 messages over the workers in worker
    order. Returns (float sum, (local,) masked nnz)."""
    pairs = [decoded_message(values[j], scale[j], mask[j], is_ternary=is_ternary)
             for j in range(values.shape[0])]
    dec = torch.stack([d for d, _ in pairs])
    return ordered_psum(dec, group), torch.stack([n for _, n in pairs])


def decoded_exchange_bucket(payload: torch.Tensor, group: WorkerGroup) -> torch.Tensor:
    """The bucketed ``decoded`` mode: ONE float32 sum, in worker order, of a
    (local, rows, 512) stack of decoded, masked messages (``decoded_message``
    per leaf, laid out by ``dist.bucketing``). The sum is element-wise, so
    each leaf's slice equals the per-leaf ``decoded_exchange`` bit for bit."""
    return ordered_psum(payload, group)


def decoded_wire_bytes(n_coords: int, n_workers: int) -> float:
    """Per-device bytes of the decoded float32 psum: one ring all-reduce of
    4 B/coord."""
    return 2.0 * (n_workers - 1) / n_workers * 4.0 * n_coords


def allreduce_scalar_bytes(n_workers: int) -> float:
    """Ring all-reduce of one float32 scalar (the shared L-inf max)."""
    return 2.0 * (n_workers - 1) / n_workers * 4.0


def uplink_ledger(mode: str, wire: "VoteWire", n_coords: int, *,
                  share_linf: bool = False) -> float:
    """Per-device uplink bytes to exchange one n-coordinate leaf under a wire
    mode (``engine.wire_mode``): the mode's payload (the wire's own
    ``wire_bytes``, or the decoded float32 psum), the pack8 wire's per-worker
    decode scales (``scalar_bytes``, widened by the weight under elastic
    participation) and the elastic weight side channel of the ternary gather
    wires, both once a ring chunk (the ring ships them with every chunk), and
    one float32 all-reduce when the compressor shares a magnitude. The JAX
    ledger's definition, its terms added in its order."""
    if mode == "decoded":
        total = decoded_wire_bytes(n_coords, wire.n_workers)
    else:
        total = wire.wire_bytes(n_coords)
    if mode == "pack8":
        total += wire.scalar_bytes() * wire.ring_chunks(n_coords)
    if mode != "decoded":
        total += wire.weight_bytes() * wire.ring_chunks(n_coords)
    if share_linf:
        total += allreduce_scalar_bytes(wire.n_workers)
    return total


def uplink_ledger_bucket(mode: str, wire: "VoteWire", n_coords: int, n_slots: int, *,
                         rows: Optional[int] = None,
                         ring_chunks: int = 1) -> Tuple[float, float]:
    """Per-device uplink bytes of ONE bucket exchange carrying ``n_slots``
    leaves in ``n_coords`` padded coordinates, split as JAX's census splits
    them: (payload bytes, scalar bytes). The payload is the wire's bucket
    model (``bucket_payload_bytes``: the fixed-rate wires at the padded
    coordinate count, golomb by its capacity ``rows``). pack8 gathers one
    float32 scale a slot (one more entry, the raw weight, under elastic
    participation) as one vector: payload from two entries on, else scalar
    traffic. The ternary gather wires' elastic weight is one scalar. Both
    side channels ride every ring chunk. The shared L-inf term is the plan's
    (``bucketing.plan_ledger``)."""
    if mode == "decoded":
        payload = decoded_wire_bytes(n_coords, wire.n_workers)
    else:
        payload = wire.bucket_payload_bytes(n_coords, rows=rows)
    scalar = 0.0
    if mode == "pack8":
        n_side = n_slots + (1 if wire.participation is not None else 0)
        scales = float((wire.n_workers - 1) * 4 * n_side) * int(ring_chunks)
        if n_side >= 2:
            payload += scales
        else:
            scalar += scales
    elif mode != "decoded":
        scalar += wire.weight_bytes() * int(ring_chunks)
    return payload, scalar


# ---------------------------------------------------------------------------
# Ring-pipelined gather: chunks round the ring, each decoded as it arrives
# ---------------------------------------------------------------------------

#: ring chunk rows when ring mode is asked for without a size, JAX's default:
#: a 32 KiB pack2 or 128 KiB pack8 chunk
DEFAULT_RING_CHUNK_ROWS = 256


def ring_perm(m: int) -> list:
    """The M-cycle i -> i + 1 (mod M): after one hop every worker holds its
    predecessor's buffer, so M - 1 hops visit every peer."""
    return [(i, (i + 1) % m) for i in range(m)]


def ring_permute(x: torch.Tensor, group: WorkerGroup) -> torch.Tensor:
    """One hop of the ring over the processes: this process's (local, ...)
    stack goes to rank + 1 and rank - 1's comes back (``batch_isend_irecv``,
    the port's only point-to-point call). With one process it is the
    identity: ``_ring_order`` steps through the local workers."""
    if group.group is None or group.world == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    nxt = dist.get_global_rank(group.group, (group.rank + 1) % group.world)
    prv = dist.get_global_rank(group.group, (group.rank - 1) % group.world)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, nxt, group=group.group),
                                   dist.P2POp(dist.irecv, out, prv, group=group.group)])
    for req in reqs:
        req.wait()
    return out


def _ring_chunk_spans(total_rows: int, chunk_rows: Optional[int]) -> tuple:
    """(row_start, rows) framing of a payload: greedy ``chunk_rows`` spans and
    a short tail; None is one chunk of the whole payload."""
    if chunk_rows is None or total_rows <= chunk_rows:
        return ((0, total_rows),)
    spans = []
    r = 0
    while r < total_rows:
        spans.append((r, min(int(chunk_rows), total_rows - r)))
        r += spans[-1][1]
    return tuple(spans)


def _slot_groups(slots, chunk_rows: Optional[int]) -> tuple:
    """Golomb framing: greedy groups of consecutive whole slots whose rows
    fit in ``chunk_rows`` (a coded stream is not row-addressable); a slot
    larger than a chunk rides alone."""
    slots = tuple(slots)
    if chunk_rows is None:
        return (slots,)
    groups, cur, cur_rows = [], [], 0
    for s in slots:
        if cur and cur_rows + s.rows > chunk_rows:
            groups.append(tuple(cur))
            cur, cur_rows = [], 0
        cur.append(s)
        cur_rows += s.rows
    if cur:
        groups.append(tuple(cur))
    return tuple(groups)


def _chunk_segments(slots, r0: int, nr: int) -> tuple:
    """The slot row ranges a [r0, r0 + nr) chunk carries, in row order:
    (slot position, slot, segment row start, segment rows). pack8 slots are
    sublane-aligned, so each segment is a whole number of kernel tiles."""
    segs = []
    for i, s in enumerate(slots):
        a = max(r0, s.row_start)
        b = min(r0 + nr, s.row_start + s.rows)
        if b > a:
            segs.append((i, s, a, b - a))
    return tuple(segs)


def _row_chunks(values, r0: int, nr: int) -> list:
    """Rows [r0, r0 + nr) of each local worker's message (a (local, rows,
    width) stack or a sequence of (rows, width) messages): views, no copy."""
    return [values[j][r0:r0 + nr] for j in range(len(values))]


def _ring_order(chunks, side: tuple, group: WorkerGroup):
    """One chunk's ring exchange: yields each message of the chunk, with its
    side rows, in the order its sum adds them.

    ``chunks[j]`` is local worker j's chunk and ``side`` holds (local, ...)
    side channels riding with it (decode scales, weights); each item is
    ``(message, side_rows)``. JAX's device w adds its own message first, then
    those of w - 1, w - 2, ... (mod M); the port keeps one replica a process
    and adds in the order of its first worker w0 = rank * local: w0, then
    each earlier process's workers from its last (one hop each), then this
    process's workers from its last down to w0 + 1. In one process: 0, M - 1,
    ..., 1. The (M, ...) stack never exists."""
    def at(bufs, sides, j):
        return bufs[j], tuple(s[j] for s in sides)

    if _CENSUSES:   # the hop loop: one record for the chunk, one a side channel
        for x in (chunks,) + tuple(side):
            _record("ppermute", x, group)
    yield at(chunks, side, 0)
    bufs, sides = chunks, side
    for _ in range(group.world - 1):
        bufs = ring_permute(bufs if torch.is_tensor(bufs) else torch.stack(list(bufs)), group)
        sides = tuple(ring_permute(s, group) for s in sides)
        for j in range(group.local - 1, -1, -1):
            yield at(bufs, sides, j)
    for j in range(group.local - 1, 0, -1):
        yield at(chunks, side, j)


def _tree_add(a, b):
    if isinstance(a, tuple):
        return tuple(x + y for x, y in zip(a, b))
    return a + b


def _ring_accumulate(chunks, side: tuple, decode_fn, group: WorkerGroup):
    """The golomb wire's hop: ``decode_fn(chunk, *side_rows)`` decodes one
    message (M = 1) to a tensor or a tuple of them, added into the
    accumulator in ``_ring_order``."""
    acc = None
    for buf, rows in _ring_order(chunks, side, group):
        d = decode_fn(buf, *rows)
        acc = d if acc is None else _tree_add(acc, d)
    return acc


def _ring_decode_into(chunks, side: tuple, decode_into, group: WorkerGroup) -> list:
    """The 2-bit and pack8 wires' hop, one launch: ``decode_into(chunk,
    *side_rows, accumulate=)`` decodes one message (M = 1) into the chunk's
    output slice, the first message writing it (``accumulate=False``) and
    every later one, local or arriving, adding into it in ``_ring_order``.
    No temporary, no add and no copy. Returns the side rows in that order
    (``_ring_total`` sums their weights once an exchange).

    The sums are those of decoding each message from +0.0 and adding it to
    the accumulator, bit for bit. The two differ only where a product is
    -0.0 (a zero weight times a -1 vote, a zero scale times a negative
    level) and the accumulator is -0.0: a decode from +0.0 turns the product
    into +0.0, the fused add keeps it. The accumulator is never -0.0: its
    first value is a sum seeded with +0.0, and in round-to-nearest x + y is
    -0.0 only when x and y both are. The integer sums are exact in any
    order."""
    order = []
    for i, (buf, rows) in enumerate(_ring_order(chunks, side, group)):
        decode_into(buf, *rows, accumulate=i > 0)
        order.append(rows)
    return order


def _ring_total(order: list) -> torch.Tensor:
    """W: the last entry of each message's side row (its raw weight), added
    in ring order, as every chunk's sum adds its products."""
    acc = None
    for (row,) in order:
        acc = row[-1] if acc is None else acc + row[-1]
    return acc


# ---------------------------------------------------------------------------
# The wire abstraction
# ---------------------------------------------------------------------------

_NO_SCALE = "exchanges raw integer votes; a decode scale inside the exchange is a pack8-wire concept"


@dataclasses.dataclass(frozen=True, eq=False)
class VoteWire:
    """One vote-exchange wire: message format + collective + byte ledger,
    built once per step by ``make_vote_wire``. ``exchange`` takes the
    (local, ...) stack of this process's workers' wire-native messages and
    returns the vote total every worker sees; ``exchange_bucket`` does the
    same for one bucket (``dist.bucketing``) and returns per-leaf sums. With
    a ``participation`` spec the elastic family (``exchange_weighted``,
    ``exchange_bucket_weighted``) is live: it returns ``(sum_m w_m *
    votes_m, W)`` with W the realized participation, per coordinate on the
    psum wires and one scalar on the gather wires."""

    group: WorkerGroup
    n_workers: int
    participation: Optional[ParticipationSpec] = None

    name = "psum"
    #: native uplink message format: "int8" leaf-shaped ternary votes,
    #: "pack2" the 2-bit packed uint8 canonical view, "golomb" the coded
    #: uint8 stream, or "pack8" the int8 level canonical view
    native_format = "int8"

    def mask_message(self, values: torch.Tensor, mask) -> torch.Tensor:
        """Zero a non-participating worker's message in wire-native format
        (an all-zero packed byte decodes to four zero votes)."""
        return torch.where(mask, values, torch.zeros((), dtype=values.dtype,
                                                     device=values.device))

    def message_nnz(self, values: torch.Tensor) -> torch.Tensor:
        """Nonzero votes in one wire-native message (float32 scalar)."""
        return torch.count_nonzero(values).to(torch.float32)

    def _check_scale(self, scale):
        if scale is not None:
            raise ValueError(f"the {self.name!r} vote wire {_NO_SCALE}")

    def _int_sum(self, values: torch.Tensor) -> torch.Tensor:
        return vote_psum(values, self.group, self.n_workers)

    def exchange(self, values: torch.Tensor, size: int, shape, *, scale=None) -> torch.Tensor:
        """(local, *shape) int8 votes -> the vote sum in ``_sum_dtype(M)``."""
        self._check_scale(scale)
        return self._int_sum(values)

    def exchange_bucket(self, payload: torch.Tensor, bucket, *, scale=None) -> list:
        """One bucket: (local, rows, 512) int8 votes -> per-leaf vote sums in
        the leaves' shapes, aligned with ``bucket.slots``. The sum is
        element-wise, so each slot equals the per-leaf ``exchange``."""
        self._check_scale(scale)
        from repro_torch.dist import bucketing  # bucketing imports this module
        return bucketing.split_bucket(self._int_sum(payload), bucket)

    def _require_participation(self):
        if self.participation is None:
            raise ValueError(
                f"the {self.name!r} wire was built without a ParticipationSpec; the "
                f"weighted exchange family is the elastic-participation path: pass "
                f"participation= to make_vote_wire")

    def _f32_sum(self, x: torch.Tensor) -> torch.Tensor:
        return ordered_sum(x)

    def _weighted_psums(self, values: torch.Tensor, weight: torch.Tensor):
        """The two float32 all-reduces of JAX's elastic psum wires, in worker
        order: the products w_m * votes_m, and each worker's weight
        broadcast to its message's shape (the per-coordinate W; the ledger
        bills both arrays)."""
        w = weight.to(torch.float32).reshape((-1,) + (1,) * (values.dim() - 1))
        wv = ordered_psum(values.to(torch.float32) * w, self.group, fold=self._f32_sum)
        wtot = ordered_psum(w.expand(values.shape), self.group, fold=self._f32_sum)
        return wv, wtot

    def exchange_weighted(self, values: torch.Tensor, size: int, shape, *, weight,
                          scale=None):
        """Elastic exchange: ``(sum_m w_m * votes_m, per-coordinate W)``.
        ``weight`` is the (local,) effective float32 weight of this process's
        workers (static weight x report bit, 0.0 for a silent worker whose
        message is already zeroed). Both sums run in worker order."""
        self._require_participation()
        self._check_scale(scale)
        return self._weighted_psums(values, weight)

    def exchange_bucket_weighted(self, payload: torch.Tensor, bucket, *, weight, scale=None):
        """Bucketed elastic exchange: (per-leaf weighted sums, per-leaf
        per-coordinate W), both aligned with ``bucket.slots``."""
        self._require_participation()
        self._check_scale(scale)
        from repro_torch.dist import bucketing  # bucketing imports this module
        wv, wtot = self._weighted_psums(payload, weight)
        return bucketing.split_bucket(wv, bucket), bucketing.split_bucket(wtot, bucket)

    def wire_bytes(self, n_coords: int) -> float:
        """Per-device wire bytes to exchange one n-coordinate leaf (ring
        collectives, real payload sizes). Under elastic participation the
        psum wires move two float32 arrays (weighted vote, participation)."""
        m = self.n_workers
        if self.participation is not None:
            return 2.0 * decoded_wire_bytes(n_coords, m)
        payload = n_coords * torch.tensor([], dtype=_sum_dtype(m)).element_size()
        return 2.0 * (m - 1) / m * payload

    def scalar_bytes(self) -> float:
        """The float32 decode scale(s) beside a leaf's payload: one ring
        all-reduce of 4 bytes (a magnitude-shared scale). The pack8 wire
        gathers one scale a worker instead."""
        m = self.n_workers
        return 2.0 * (m - 1) / m * 4.0

    def weight_bytes(self) -> float:
        """Elastic weight side channel beside one payload exchange (or ring
        chunk): 0 on the psum wires, whose participation payload is in
        ``wire_bytes``, and on the pack8 wire, whose weight widens
        ``scalar_bytes``."""
        return 0.0

    def bucket_payload_bytes(self, n_coords: int, rows: Optional[int] = None) -> float:
        """Payload ledger of ONE bucket: the fixed-rate wires at the padded
        coordinate count; golomb bills its capacity rows."""
        return self.wire_bytes(n_coords)

    def ring_chunks(self, n_coords: int) -> int:
        """Ring chunks (payload exchanges) for one n-coordinate leaf: 1 unless
        a gather wire rings it in chunks."""
        return 1

    def bucket_ring_chunks(self, bucket) -> int:
        """Ring chunks for ONE bucket exchange."""
        return 1

    def gather_hbm_bytes(self, n_coords: int) -> float:
        """Peak device memory of the gathered payload for one leaf: M messages
        for a monolithic gather, two chunks for the ring, 0 for the psum
        wires, which never hold a gathered tensor."""
        return 0.0

    def bucket_gather_hbm_bytes(self, bucket) -> float:
        """Peak gathered-payload memory for ONE bucket exchange."""
        return 0.0

    def for_slice(self, leaf_n: int) -> "VoteWire":
        """The wire that carries a model rank's slice of an
        ``leaf_n``-coordinate leaf (tensor parallelism): this one, for a wire
        whose message size follows the slice's coordinates alone."""
        return self


@dataclasses.dataclass(frozen=True, eq=False)
class HierVoteWire(VoteWire):
    """Two-level sum: narrow within ``axes[1]`` (inner), widened across
    ``axes[0]`` (outer). Needs exactly two worker axes."""

    inner_size: int = 1
    outer_size: int = 1

    name = "hier"

    def _int_sum(self, values):
        inner_dt = _sum_dtype(self.inner_size)
        outer_dt = _sum_dtype(self.inner_size * self.outer_size)
        local = values.shape[0]
        if local % self.inner_size == 0:
            # whole inner groups live here: the narrow inner sum, then the
            # widened outer one (integer sums: exact in any grouping)
            inner = torch.sum(values.to(inner_dt).reshape(
                (local // self.inner_size, self.inner_size) + tuple(values.shape[1:])),
                dim=1, dtype=inner_dt)
            part = torch.sum(inner.to(outer_dt), dim=0, dtype=outer_dt)
        else:
            part = torch.sum(values.to(outer_dt), dim=0, dtype=outer_dt)
        return self.group.all_reduce(part)

    def _f32_sum(self, x: torch.Tensor) -> torch.Tensor:
        """(M, ...) float32 -> the inner sums in worker order, then the outer
        sum over them in order: the two-level association of the hier wire."""
        grouped = x.reshape((self.outer_size, self.inner_size) + tuple(x.shape[1:]))
        return ordered_sum(torch.stack([ordered_sum(grouped[o])
                                        for o in range(self.outer_size)]))

    def wire_bytes(self, n_coords):
        ni, no = self.inner_size, self.outer_size
        if self.participation is not None:
            inner = 2.0 * (ni - 1) / ni * 4.0 * n_coords
            outer = 2.0 * (no - 1) / no * 4.0 * n_coords
            return 2.0 * (inner + outer)
        isz = torch.tensor([], dtype=_sum_dtype(ni)).element_size()
        osz = torch.tensor([], dtype=_sum_dtype(ni * no)).element_size()
        inner = 2.0 * (ni - 1) / ni * n_coords * isz
        outer = 2.0 * (no - 1) / no * n_coords * osz
        return inner + outer


@dataclasses.dataclass(frozen=True, eq=False)
class PackedVoteWire(VoteWire):
    """All-gather of the 2-bit packed wire + the fused decode-sum kernel. The
    message IS the packed canonical view, written in one pass by the fused
    compress kernels on the card. With ``ring_chunk_rows`` the gather is the
    chunked ring (module docstring), its sums equal to the monolithic
    gather's. ``backend="torch"`` decodes with the plain versions (the
    kernels' comparison on the card); the default follows the tensor's
    device."""

    backend: Optional[str] = None
    ring_chunk_rows: Optional[int] = None

    name = "allgather_packed"
    native_format = "pack2"

    def message_nnz(self, values):
        # nonzero 2-bit codes straight off the bytes: codes are {0, 1, 2}, so
        # (b | b >> 1) has bit 0 of each code set iff the code is nonzero
        nz = (values | (values >> 1)) & 0x55
        cnt = (nz & 1) + ((nz >> 2) & 1) + ((nz >> 4) & 1) + ((nz >> 6) & 1)
        return torch.sum(cnt, dtype=torch.int64).to(torch.float32)

    def _check_scale(self, scale):
        if scale is not None:
            raise ValueError("the 2-bit packed vote wire exchanges raw ternary votes; a "
                             "decode scale inside the exchange is a pack8-wire concept")

    def _sum(self, gathered, size, shape, **into):
        """The decode-sum; ``into``: the kernel's ``out=`` and ``accumulate=``."""
        if self.backend == "torch":
            return from_2d(unpack2bit_sum_ref(gathered, **into), size, shape)
        return unpack2bit_sum_op(gathered, size, shape, **into)

    def _wsum(self, gathered, weights, size, shape, **into):
        if self.backend == "torch":
            return from_2d(unpack2bit_wsum_ref(gathered, weights, **into), size, shape)
        return unpack2bit_wsum_op(gathered, weights, size, shape, **into)

    def _ring_sum(self, values) -> torch.Tensor:
        """Ring (rows, 128) packed messages in row chunks: each message is
        decoded straight into its chunk of one flat output of rows x 512 sums
        in ``_sum_dtype(M)`` (the values JAX's int32 concatenation holds, a
        quarter of its memory at M = 4). Each chunk is a self-contained pack2
        stream."""
        rows = values[0].shape[0]
        out = torch.empty(rows * LANES, dtype=_sum_dtype(self.n_workers),
                          device=values[0].device)
        for r0, nr in _ring_chunk_spans(rows, self.ring_chunk_rows):
            o = out[r0 * LANES:(r0 + nr) * LANES]
            _ring_decode_into(_row_chunks(values, r0, nr), (),
                              lambda b, accumulate, _o=o: self._sum(
                                  b[None], _o.numel(), _o.shape, out=_o, accumulate=accumulate),
                              self.group)
        return out

    def _ring_wsum(self, values, weight):
        """The weighted ring: the (1,) effective weight rides every chunk
        (the ledger's ``weight_bytes x ring_chunks``), each message decoded
        by the weighted decode-sum at M = 1 into its chunk of the output;
        the weights add up once, in the same ring order, into W. Returns
        (flat float32 sums, W)."""
        rows = values[0].shape[0]
        out = torch.empty(rows * LANES, dtype=torch.float32, device=values[0].device)
        side = (weight.to(torch.float32).reshape(-1, 1),)
        order = None
        for r0, nr in _ring_chunk_spans(rows, self.ring_chunk_rows):
            o = out[r0 * LANES:(r0 + nr) * LANES]
            got = _ring_decode_into(_row_chunks(values, r0, nr), side,
                                    lambda b, w, accumulate, _o=o: self._wsum(
                                        b[None], w, _o.numel(), _o.shape, out=_o,
                                        accumulate=accumulate),
                                    self.group)
            order = got if order is None else order
        return out, _ring_total(order)

    def _gather_sum(self, payload, size, shape):
        """The monolithic gather and ONE decode-sum over it, written straight
        in ``_sum_dtype(M)``."""
        gathered = self.group.gather(payload)
        out = torch.empty(gathered.shape[1] * LANES, dtype=_sum_dtype(self.n_workers),
                          device=gathered.device)
        return self._sum(gathered, size, shape, out=out)

    def exchange(self, values, size, shape, *, scale=None):
        """(local, rows, 128) packed messages (or, on the ring, a sequence of
        them) -> the vote sum of ``shape`` in ``_sum_dtype(M)``."""
        self._check_scale(scale)
        if self.ring_chunk_rows is not None:
            return self._ring_sum(values)[:size].reshape(shape)
        return self._gather_sum(values, size, shape)

    def exchange_bucket(self, payload, bucket, *, scale=None):
        """ONE gather of the whole packed bucket and one decode-sum over it
        (or the ring over it, chunked on any sublane-aligned row), then the
        split. pack2 packs each row on its own, so the bucket is itself a
        pack2 stream and its decode equals the per-leaf decodes."""
        self._check_scale(scale)
        from repro_torch.dist import bucketing  # bucketing imports this module
        if self.ring_chunk_rows is not None:
            return bucketing.split_bucket(self._ring_sum(payload), bucket)
        n = bucket.n_coords
        return bucketing.split_bucket(self._gather_sum(payload, n, (n,)), bucket)

    def exchange_weighted(self, values, size, shape, *, weight, scale=None):
        self._require_participation()
        self._check_scale(scale)
        if self.ring_chunk_rows is not None:
            flat, wtot = self._ring_wsum(values, weight)
            return flat[:size].reshape(shape), wtot
        wvec = self.group.gather(weight.to(torch.float32).reshape(-1))
        return self._wsum(self.group.gather(values), wvec, size, shape), ordered_sum(wvec)

    def exchange_bucket_weighted(self, payload, bucket, *, weight, scale=None):
        self._require_participation()
        self._check_scale(scale)
        from repro_torch.dist import bucketing  # bucketing imports this module
        if self.ring_chunk_rows is not None:
            flat, wtot = self._ring_wsum(payload, weight)
            return bucketing.split_bucket(flat, bucket), wtot
        n = bucket.n_coords
        wvec = self.group.gather(weight.to(torch.float32).reshape(-1))
        total = self._wsum(self.group.gather(payload), wvec, n, (n,))
        return bucketing.split_bucket(total, bucket), ordered_sum(wvec)

    def weight_bytes(self):
        # the (1,) float32 effective weight gathered from M - 1 peers
        if self.participation is None:
            return 0.0
        return float((self.n_workers - 1) * 4.0)

    def wire_bytes(self, n_coords):
        # all-gather: each device sends its padded packed payload to M - 1
        # peers; the ring moves the same bytes
        return float((self.n_workers - 1) * packed_nbytes(n_coords))

    def ring_chunks(self, n_coords):
        return len(_ring_chunk_spans(canonical_rows(n_coords), self.ring_chunk_rows))

    def bucket_ring_chunks(self, bucket):
        return len(_ring_chunk_spans(bucket.rows, self.ring_chunk_rows))

    def _gather_hbm(self, rows: int) -> float:
        if self.ring_chunk_rows is None:
            return float(self.n_workers * rows * PACKED_WIDTH)
        max_nr = max(nr for _, nr in _ring_chunk_spans(rows, self.ring_chunk_rows))
        return float(2 * max_nr * PACKED_WIDTH)

    def gather_hbm_bytes(self, n_coords):
        return self._gather_hbm(canonical_rows(n_coords))

    def bucket_gather_hbm_bytes(self, bucket):
        return self._gather_hbm(bucket.rows)


@dataclasses.dataclass(frozen=True, eq=False)
class GolombWire(VoteWire):
    """All-gather of Golomb/Rice entropy-coded ternary messages + the fused
    decode-sum kernel: the sub-2-bit variable-length wire.

    The message is a fixed-capacity uint8 stream sized when the step is
    built from the plan fraction ``p`` (``golomb_rows``): coded zero-run gaps
    and sign bits behind a header of the shipped and dropped nonzero counts,
    so a gathered buffer is self-describing. The static capacity keeps the
    exchange a fixed-shape all-gather, and the ledger (padding included) the
    bytes the gather moves. A message denser than the plan is truncated at
    capacity with the dropped count in its header. With ``ring_chunk_rows``
    the gather is the ring, chunked on stream boundaries (a coded stream is
    not row-addressable): a leaf's message is one chunk, a bucket rings
    groups of whole slots (``_slot_groups``). ``backend="torch"`` decodes
    with the plain versions; the default follows the tensor."""

    backend: Optional[str] = None
    p: float = 0.05
    ring_chunk_rows: Optional[int] = None
    #: a model rank's slice of a leaf of this many coordinates (``for_slice``):
    #: the leaf's capacity bounds the slice's nonzeros (``golomb_rows``)
    leaf_n: Optional[int] = None

    name = "allgather_golomb"
    native_format = "golomb"

    def for_slice(self, leaf_n: int) -> "GolombWire":
        """The wire of a model rank's slice of an ``leaf_n``-coordinate leaf:
        its message holds as many nonzeros as the whole leaf's would, since
        a budget solved for the whole leaf may put more than the slice's
        share in it, and its own unary spill."""
        return dataclasses.replace(self, leaf_n=int(leaf_n))

    @staticmethod
    def _header_count(values, at: int) -> torch.Tensor:
        # a uint32 little-endian header field, as float32 in JAX's order of sums
        h = values.reshape(-1)[at:at + 4].to(torch.float32)
        return h[0] + h[1] * 256.0 + h[2] * 65536.0 + h[3] * 16777216.0

    def message_nnz(self, values):
        # the header is the count: shipped nonzeros, what the vote sum will see
        return self._header_count(values, 0)

    def message_dropped(self, values):
        """Nonzeros truncated at capacity (header bytes 4-7): the overflow
        count a caller can report when the realized nnz outruns the plan."""
        return self._header_count(values, 4)

    def _check_scale(self, scale):
        if scale is not None:
            raise ValueError("the golomb vote wire exchanges entropy-coded ternary votes; a "
                             "decode scale inside the exchange is a pack8-wire concept")

    def _sum(self, gathered, size, shape):
        return _golomb_decode_sum(gathered, size, shape, p=self.p, backend=self.backend)

    def _wsum(self, gathered, weights, size, shape):
        return _golomb_decode_wsum(gathered, weights, size, shape, p=self.p,
                                   backend=self.backend)

    def exchange(self, values, size, shape, *, scale=None):
        self._check_scale(scale)
        sd = _sum_dtype(self.n_workers)
        if self.ring_chunk_rows is not None:
            # one leaf, one self-describing capacity stream, one chunk
            return _ring_accumulate(values, (), lambda b: self._sum(b[None], size, shape),
                                    self.group).to(sd)
        return self._sum(self.group.gather(values), size, shape).to(sd)

    def _ring_bucket(self, payload, bucket, weight=None):
        """Ring a bucket in whole-slot groups: a group's rows are one chunk,
        decoded slot by slot (each slot carries its own header); with a
        weight, the (1,) weight rides every group and adds up into W."""
        out = [None] * len(bucket.slots)
        pos = {s: i for i, s in enumerate(bucket.slots)}
        side = () if weight is None else (weight.to(torch.float32).reshape(-1, 1),)
        sd = _sum_dtype(self.n_workers)
        wtot = None
        for g in _slot_groups(bucket.slots, self.ring_chunk_rows):
            r0 = g[0].row_start

            def decode(b, *w, _g=g, _r0=r0):
                segs = [b[s.row_start - _r0:s.row_start - _r0 + s.rows][None] for s in _g]
                if not w:
                    return tuple(self._sum(x, s.size, s.shape) for x, s in zip(segs, _g))
                return tuple(self._wsum(x, w[0], s.size, s.shape)
                             for x, s in zip(segs, _g)) + (w[0][0],)

            part = _ring_accumulate(_row_chunks(payload, r0, sum(s.rows for s in g)), side,
                                    decode, self.group)
            if weight is not None:
                wtot = part[-1] if wtot is None else wtot
                part = part[:-1]
            for s, arr in zip(g, part):
                out[pos[s]] = arr if weight is not None else arr.to(sd)
        return out if weight is None else (out, wtot)

    def exchange_bucket(self, payload, bucket, *, scale=None):
        """ONE gather of the whole coded bucket, then a decode-sum per slot
        on its gathered rows: each slot is a whole stream with its own
        header, decoded as the per-leaf message."""
        self._check_scale(scale)
        if self.ring_chunk_rows is not None:
            return self._ring_bucket(payload, bucket)
        gathered = self.group.gather(payload)
        sd = _sum_dtype(self.n_workers)
        return [self._sum(gathered[:, s.row_start:s.row_start + s.rows], s.size,
                          s.shape).to(sd) for s in bucket.slots]

    def exchange_weighted(self, values, size, shape, *, weight, scale=None):
        self._require_participation()
        self._check_scale(scale)
        if self.ring_chunk_rows is not None:
            # one stream, one chunk; the (1,) weight rides with it
            return _ring_accumulate(values, (weight.to(torch.float32).reshape(-1, 1),),
                                    lambda b, w: (self._wsum(b[None], w, size, shape), w[0]),
                                    self.group)
        wvec = self.group.gather(weight.to(torch.float32).reshape(-1))
        return self._wsum(self.group.gather(values), wvec, size, shape), ordered_sum(wvec)

    def exchange_bucket_weighted(self, payload, bucket, *, weight, scale=None):
        self._require_participation()
        self._check_scale(scale)
        if self.ring_chunk_rows is not None:
            return self._ring_bucket(payload, bucket, weight)
        gathered = self.group.gather(payload)
        wvec = self.group.gather(weight.to(torch.float32).reshape(-1))
        return ([self._wsum(gathered[:, s.row_start:s.row_start + s.rows], wvec, s.size,
                            s.shape) for s in bucket.slots], ordered_sum(wvec))

    def weight_bytes(self):
        # the (1,) float32 effective weight gathered from M - 1 peers
        if self.participation is None:
            return 0.0
        return float((self.n_workers - 1) * 4.0)

    def wire_bytes(self, n_coords):
        # all-gather of the capacity-padded coded payload to M - 1 peers
        return float((self.n_workers - 1)
                     * golomb_payload_nbytes(n_coords, self.p, self.leaf_n))

    def bucket_payload_bytes(self, n_coords, rows=None):
        # bucket rows are capacity rows, not coordinate rows: bill exactly the
        # (rows, 128) uint8 buffer the gather ships
        assert rows is not None, "the golomb bucket ledger needs the bucket's payload rows"
        return float((self.n_workers - 1) * rows * ROW_BYTES)

    def payload_rows(self, n_coords: int, leaf_n: Optional[int] = None) -> int:
        """Capacity rows of one n-coordinate message at the wire's plan
        fraction (a slice of an ``leaf_n``-coordinate leaf: its leaf's
        capacity, else the wire's ``leaf_n``): the bucket plan's ``rows_fn``
        for this wire."""
        return golomb_rows(n_coords, self.p, self.leaf_n if leaf_n is None else leaf_n)

    def bucket_ring_chunks(self, bucket):
        return len(_slot_groups(bucket.slots, self.ring_chunk_rows))

    def gather_hbm_bytes(self, n_coords):
        rows = golomb_rows(n_coords, self.p, self.leaf_n)
        if self.ring_chunk_rows is None:
            return float(self.n_workers * rows * ROW_BYTES)
        # a leaf's stream is one chunk whatever its size: two whole streams
        return float(2 * rows * ROW_BYTES)

    def bucket_gather_hbm_bytes(self, bucket):
        if self.ring_chunk_rows is None:
            return float(self.n_workers * bucket.rows * ROW_BYTES)
        max_rows = max(sum(s.rows for s in g)
                       for g in _slot_groups(bucket.slots, self.ring_chunk_rows))
        return float(2 * max_rows * ROW_BYTES)


@dataclasses.dataclass(frozen=True, eq=False)
class Pack8Wire(VoteWire):
    """All-gather of int8 sign*level payloads (the pack8 wire format) + the
    fused dequantize-sum kernel: the non-ternary 8-bit twin of
    ``PackedVoteWire``. The message is the canonical (rows, 512) int8 view of
    the signed levels, written in one pass by the fused ``qsgd8_pack8``
    kernel on the card; each worker's float32 decode scale rides the gather
    beside it, and the exchange returns the float32 decoded sum the mean
    server consumes. With ``ring_chunk_rows`` the ring carries the payload in
    sublane-tile chunks with the scales as a side channel on every chunk;
    its float sums then run in ring order (module docstring), as JAX's do.
    ``backend="torch"`` decodes with the plain version, the ring included;
    the default follows the tensor."""

    backend: Optional[str] = None
    ring_chunk_rows: Optional[int] = None

    name = "allgather_packed8"
    native_format = "pack8"

    # message_nnz is the base count of nonzero levels (not their magnitudes)

    def _decode_sum(self, gathered, scales, size, shape, **into):
        """The decode-sum; ``into``: the kernel's ``out=`` and ``accumulate=``."""
        if self.backend == "torch":
            return from_2d(unpack8_sum_ref(gathered, scales, **into), size, shape)
        return unpack8_sum_op(gathered, scales, size, shape, **into)

    @staticmethod
    def _need_scale(scale, what="each worker's decode scale (CompressedGrad.scale)"):
        if scale is None:
            raise ValueError(f"the pack8 wire dequantizes during the exchange and needs {what}")
        return torch.as_tensor(scale, dtype=torch.float32)

    def _ring(self, values, side, size, shape, weighted: bool):
        """Ring one leaf: ``side`` (local, 1) scales, or (local, 2) ``[scale *
        w, w]``, rides every chunk; each message decoded at M = 1 with its
        own scale into its chunk of the output; under a weight the raw
        weights add up once, in ring order, into W."""
        rows = values[0].shape[0]
        out = torch.empty(rows * LANES, dtype=torch.float32, device=values[0].device)
        order = None
        for r0, nr in _ring_chunk_spans(rows, self.ring_chunk_rows):
            o = out[r0 * LANES:(r0 + nr) * LANES]
            got = _ring_decode_into(_row_chunks(values, r0, nr), (side,),
                                    lambda b, s, accumulate, _o=o: self._decode_sum(
                                        b[None], s[0:1], _o.numel(), _o.shape, out=_o,
                                        accumulate=accumulate),
                                    self.group)
            order = got if order is None else order
        total = out[:size].reshape(shape)
        return (total, _ring_total(order)) if weighted else total

    def exchange(self, values, size, shape, *, scale=None):
        """(local, rows, 512) int8 levels (or, on the ring, a sequence of
        them) + (local,) float32 decode scales -> the float32 decoded sum
        ``sum_m scale_m * levels_m`` of ``shape``, in worker (gather) order,
        or in ring order on the ring."""
        sc = self._need_scale(scale).reshape(-1).to(values[0].device)
        if self.ring_chunk_rows is not None:
            return self._ring(values, sc.reshape(-1, 1), size, shape, weighted=False)
        return self._decode_sum(self.group.gather(values), self.group.gather(sc), size, shape)

    def exchange_weighted(self, values, size, shape, *, weight, scale=None):
        """Elastic exchange: the effective weight premultiplies the decode
        scale (a dropped worker's scale * 0 zeroes its contribution; the
        kernel is unchanged) and ships raw beside it, in the (local, 2) side
        channel ``[scale * w, w]``. Returns ``(sum_m scale_m w_m levels_m,
        W)`` with W the realized participation."""
        self._require_participation()
        sc = self._need_scale(scale).reshape(-1).to(values[0].device)
        w = weight.to(torch.float32).reshape(-1)
        side = torch.stack([sc * w, w], dim=1)
        if self.ring_chunk_rows is not None:
            return self._ring(values, side, size, shape, weighted=True)
        sides = self.group.gather(side)
        wv = self._decode_sum(self.group.gather(values), sides[:, 0].contiguous(), size, shape)
        return wv, ordered_sum(sides[:, 1])

    def _ring_bucket(self, payload, side, bucket, weighted: bool):
        """Ring one bucket in sublane-tile chunks with the whole (local,
        n_slots [+ 1]) side vector on every chunk; each chunk/slot segment
        decodes with that slot's scale into its rows of the slot's output."""
        dev = payload.device
        outs = [torch.empty(s.rows * LANES, dtype=torch.float32, device=dev)
                for s in bucket.slots]
        order = None
        for r0, nr in _ring_chunk_spans(bucket.rows, self.ring_chunk_rows):
            segs = _chunk_segments(bucket.slots, r0, nr)

            def decode(b, sc, accumulate, _segs=segs, _r0=r0):
                for i, s, a, k in _segs:
                    o = (a - s.row_start) * LANES
                    self._decode_sum(b[a - _r0:a - _r0 + k][None], sc[i:i + 1], k * LANES,
                                     (k * LANES,), out=outs[i][o:o + k * LANES],
                                     accumulate=accumulate)

            got = _ring_decode_into(_row_chunks(payload, r0, nr), (side,), decode, self.group)
            order = got if order is None else order
        result = [o[:s.size].reshape(s.shape) for s, o in zip(bucket.slots, outs)]
        return (result, _ring_total(order)) if weighted else result

    def _per_slot(self, payload, scales, bucket):
        gathered = self.group.gather(payload)
        return [self._decode_sum(gathered[:, s.row_start:s.row_start + s.rows],
                                 scales[:, i].contiguous(), s.size, s.shape)
                for i, s in enumerate(bucket.slots)]

    def exchange_bucket(self, payload, bucket, *, scale=None):
        """ONE payload gather and ONE (n_slots,) scale-vector gather for the
        whole bucket; slots are sublane-aligned, so each slot's gathered rows
        are its per-leaf canonical view, decoded with that slot's scales in
        worker order: the per-leaf wire bit for bit. ``scale`` is the
        (local, n_slots) float32 decode scales."""
        sc = self._need_scale(scale, "the bucket's per-slot decode scales (one float32 a "
                                     "leaf)").to(payload.device)
        sc = sc.reshape(payload.shape[0], -1)
        assert sc.shape[1] == len(bucket.slots), (tuple(sc.shape), len(bucket.slots))
        if self.ring_chunk_rows is not None:
            return self._ring_bucket(payload, sc, bucket, weighted=False)
        return self._per_slot(payload, self.group.gather(sc), bucket)

    def exchange_bucket_weighted(self, payload, bucket, *, weight, scale=None):
        """Bucketed elastic exchange: the per-slot scales premultiplied by the
        effective weight and widened by one raw-weight entry, ONE (n_slots +
        1,) side vector a worker."""
        self._require_participation()
        sc = self._need_scale(scale, "the bucket's per-slot decode scales (one float32 a "
                                     "leaf)").to(payload.device)
        sc = sc.reshape(payload.shape[0], -1)
        assert sc.shape[1] == len(bucket.slots), (tuple(sc.shape), len(bucket.slots))
        w = weight.to(torch.float32).reshape(-1, 1)
        side = torch.cat([sc * w, w], dim=1)
        if self.ring_chunk_rows is not None:
            return self._ring_bucket(payload, side, bucket, weighted=True)
        sides = self.group.gather(side)
        return self._per_slot(payload, sides, bucket), ordered_sum(sides[:, -1])

    def scalar_bytes(self):
        # each worker's decode scale rides the gather to M - 1 peers (once a
        # ring chunk, uplink_ledger's factor); under elastic participation the
        # slot widens to 8 B (scale * w, w)
        per = 8.0 if self.participation is not None else 4.0
        return float((self.n_workers - 1) * per)

    def wire_bytes(self, n_coords):
        # all-gather of the padded int8 payload to M - 1 peers
        return float((self.n_workers - 1) * packed8_nbytes(n_coords))

    def ring_chunks(self, n_coords):
        return len(_ring_chunk_spans(canonical_rows(n_coords), self.ring_chunk_rows))

    def bucket_ring_chunks(self, bucket):
        return len(_ring_chunk_spans(bucket.rows, self.ring_chunk_rows))

    def _gather_hbm(self, rows: int) -> float:
        if self.ring_chunk_rows is None:
            return float(self.n_workers * rows * LANES)
        max_nr = max(nr for _, nr in _ring_chunk_spans(rows, self.ring_chunk_rows))
        return float(2 * max_nr * LANES)

    def gather_hbm_bytes(self, n_coords):
        return self._gather_hbm(canonical_rows(n_coords))

    def bucket_gather_hbm_bytes(self, bucket):
        return self._gather_hbm(bucket.rows)


def make_vote_wire(impl: str, group: WorkerGroup, *, backend: Optional[str] = None,
                   wire_format: str = "pack2", golomb_p: Optional[float] = None,
                   ring_chunk_rows: Optional[int] = None,
                   participation: Optional[ParticipationSpec] = None) -> VoteWire:
    """Build the wire for ``impl`` over the worker group at step-build time,
    with the JAX builder's validation (same cases, same errors).
    ``wire_format="golomb"`` (``allgather_packed`` only) builds the golomb
    wire at plan fraction ``golomb_p``, ``wire_format="pack8"``
    (``allgather_packed`` only) the 8-bit level wire. ``ring_chunk_rows``
    (the gather wires only; a positive multiple of 32, e.g.
    ``DEFAULT_RING_CHUNK_ROWS``) makes the gather the chunked ring."""
    if participation is not None and not isinstance(participation, ParticipationSpec):
        raise TypeError(f"participation must be a ParticipationSpec, got "
                        f"{type(participation).__name__}")
    if impl not in VOTE_IMPLS:
        raise ValueError(f"unknown vote_impl {impl!r}; known: {VOTE_IMPLS}")
    axes = tuple(group.axes)
    if impl == "hier" and len(axes) != 2:
        raise ValueError(
            f"vote_impl='hier' needs exactly two worker axes (outer, inner), e.g. "
            f"('pod', 'data'), got {axes!r}. Use vote_impl='psum' for a flat worker "
            f"domain.")
    if wire_format not in ("pack2", "golomb", "pack8"):
        raise ValueError(
            f"unknown wire payload format {wire_format!r}; the vote wires speak "
            f"'pack2'/'golomb' (ternary) or 'pack8' (8-bit levels); the float format "
            f"rides the decoded psum, not a VoteWire")
    if wire_format == "pack8" and impl != "allgather_packed":
        raise ValueError(f"the pack8 wire needs vote_impl='allgather_packed', got {impl!r}")
    if wire_format == "golomb":
        if impl != "allgather_packed":
            raise ValueError(f"the golomb wire needs vote_impl='allgather_packed', got "
                             f"{impl!r}")
        if golomb_p is None:
            raise ValueError("the golomb wire needs golomb_p (the plan-time nonzero "
                             "fraction that sizes its static capacity)")
        if not 0.0 < float(golomb_p) < 1.0:
            raise ValueError(f"golomb plan fraction must be in (0,1), got {golomb_p}")
    if ring_chunk_rows is not None:
        if impl != "allgather_packed":
            raise ValueError(
                f"ring_chunk_rows is a gather-wire concept; vote_impl={impl!r} never "
                f"materializes a gathered tensor")
        r = int(ring_chunk_rows)
        if r <= 0 or r % SUBLANE_PAD != 0:
            raise ValueError(f"ring_chunk_rows must be a positive multiple of the sublane "
                             f"tile ({SUBLANE_PAD}), got {ring_chunk_rows!r}")
        ring_chunk_rows = r
    sizes = tuple(group.sizes)
    if any(s < 1 for s in sizes):
        raise ValueError(f"vote wire needs >= 1 worker: axes {axes!r} have sizes {sizes!r}")
    n = group.n_workers
    if participation is not None:
        participation.weights_array(n)   # the weights must cover the fleet
    if wire_format == "pack8":
        return Pack8Wire(group=group, n_workers=n, backend=backend,
                         ring_chunk_rows=ring_chunk_rows, participation=participation)
    if wire_format == "golomb":
        return GolombWire(group=group, n_workers=n, backend=backend, p=float(golomb_p),
                          ring_chunk_rows=ring_chunk_rows, participation=participation)
    if impl == "hier":
        return HierVoteWire(group=group, n_workers=n, inner_size=sizes[1],
                            outer_size=sizes[0], participation=participation)
    if impl == "allgather_packed":
        return PackedVoteWire(group=group, n_workers=n, backend=backend,
                              ring_chunk_rows=ring_chunk_rows, participation=participation)
    return VoteWire(group=group, n_workers=n, participation=participation)
