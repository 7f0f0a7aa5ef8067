"""Backend-dispatching compression/server engine, the port of
``repro.core.engine``: the one hot path of the federated round.

Two backends, bit for bit the same by construction (they share the counter
hash of ``core.prng``, which the CUDA kernels regenerate in registers):

  cuda  — the hand-written kernels: sparsign, ternary, qsgd8, vote_update,
          weighted_vote_update, ef_server, and the wires' fused encoders.
  torch — the plain PyTorch versions.

The backend follows the tensor: a CUDA tensor takes the kernels and a CPU
tensor the plain versions. ``backend="torch"`` on a CUDA tensor is an
explicit request for the plain versions on the card, which is how the kernels
are compared with them; no environment variable can select it.

Two primitives:

  compress_leaf(g, cfg, seed, counter_base)   — worker uplink Q(g, B)
  server_apply(p, vote_sum, cfg, ...)         — C(.) [+ EF] + SGD update

``compress_leaf`` takes one message, or all workers' messages at once as a
(workers, ...) tensor with one seed per row: one kernel launch per round.
With a ``wire`` (``repro_torch.dist.collectives``) it returns one message in
the wire's native format: the 2-bit packed canonical view on the
``allgather_packed`` wire, the Golomb/Rice coded stream on the golomb gather
wire, or the int8 level view on the pack8 wire, produced by the spec's fused
kernel on the card.

Around them, the helpers that keep compressor and server names out of the
trainer: wire-mode negotiation (``wire_mode``, ``wire_payload_format``,
``resolve_golomb_p``, ``resolve_ring_chunk_rows``), the per-leaf quorum
(``broadcast_quorum``), and ``compress_leaf_rows``, a message laid out as its
bucket slot.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, TYPE_CHECKING

import torch

from repro_torch.core.budgets import (BudgetConfig, resolve_budget,
                                     solve_budget_for_sparsity_slices)
from repro_torch.core.compressors import (LEAF_SCALES, LEAF_STATS, CompressedGrad,
                                          chunked_values, get_spec)
from repro_torch.kernels.common import SUBLANE_PAD, device_tensor, jnp_sign, to_2d
from repro_torch.kernels.ef_server.ops import ef_server_op
from repro_torch.kernels.ef_server.ref import ef_server_ref
from repro_torch.kernels.golomb.ops import golomb_pack_op
from repro_torch.kernels.golomb.ref import golomb_encode_ref
from repro_torch.kernels.pack2bit.ops import pack2bit_op
from repro_torch.kernels.pack2bit.ref import pack2bit_ref
from repro_torch.kernels.vote_update.ops import vote_update_op, weighted_vote_update_op
from repro_torch.kernels.vote_update.ref import vote_update_ref, weighted_vote_update_ref

if TYPE_CHECKING:  # algorithm imports this module
    from repro_torch.core.algorithm import CompressionConfig

BACKENDS = ("cuda", "torch")
VOTE_SERVERS = ("majority_vote", "scaled_sign_ef")
SERVER_RULES = ("majority_vote", "scaled_sign_ef", "mean")
# how a compressor's messages ride the worker wire (see wire_mode)
WIRE_MODES = ("votes", "scaled_votes", "pack8", "decoded")


def resolve_backend(backend: Optional[str], x: torch.Tensor) -> str:
    """None -> ``cuda`` for a CUDA tensor, ``torch`` for a CPU tensor.
    ``cuda`` on a CPU tensor raises."""
    if backend is None:
        return "cuda" if x.is_cuda else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; known: {BACKENDS}")
    if backend == "cuda" and not x.is_cuda:
        raise ValueError(f"backend 'cuda' needs a CUDA tensor, got device {x.device}")
    return backend


def is_vote_server(cfg: "CompressionConfig") -> bool:
    return cfg.server in VOTE_SERVERS


def needs_server_ef(server: str) -> bool:
    """Does this server rule carry a server-side error-feedback residual?"""
    return server == "scaled_sign_ef"


def wire_mode(cfg: "CompressionConfig", vote_impl: Optional[str] = None) -> str:
    """How this (compressor, server, vote_impl) triple's uplink rides the
    worker wire, a lookup on the spec's ``wire_format`` as in the JAX engine:

      votes        -- ternary symbols on the integer or packed vote wire,
                      consumed raw by a vote server;
      scaled_votes -- ternary symbols plus ONE shared decode scale (protocol
                      none or shared_max), for a mean server;
      pack8        -- int8 sign*level payloads (1 B a coordinate) plus each
                      worker's float32 decode scale on the gather wire,
                      dequantized into the mean server's float sum during
                      the exchange. It needs ``vote_impl='allgather_packed'``:
                      a psum cannot add levels quantized against different
                      norms, so the psum and hier impls take the decoded wire;
      decoded      -- decoded float32 messages summed in float32, for a mean
                      server (per-worker scales, and the float format)."""
    spec = get_spec(cfg.compressor)
    if spec.wire_format == "float":
        return "decoded"
    if spec.wire_format == "pack8":
        return "pack8" if vote_impl == "allgather_packed" else "decoded"
    if is_vote_server(cfg):
        return "votes"
    return "scaled_votes" if spec.scale_shared else "decoded"


def wire_payload_format(cfg: "CompressionConfig", mode: str,
                        vote_impl: Optional[str] = None) -> str:
    """The payload format the wire object speaks for this triple (the
    ``make_vote_wire`` ``wire_format=`` argument), a lookup on the spec's
    ``wire_format`` as in the JAX engine. The entropy-coded stream needs the
    gather wire (a fabric psum cannot sum variable-length byte streams), so a
    golomb-format row on the psum and hier impls rides int8 votes: the same
    votes either way, as the pack8 row falls back to the decoded wire."""
    if mode == "pack8":
        return "pack8"
    spec = get_spec(cfg.compressor)
    if (spec.wire_format == "golomb" and vote_impl == "allgather_packed"
            and mode in ("votes", "scaled_votes")):
        return "golomb"
    return "pack2"


def resolve_golomb_p(cfg: "CompressionConfig", golomb_p: Optional[float] = None) -> float:
    """The plan-time nonzero fraction that sizes the golomb wire's static
    capacity: an explicit setting wins, else a ``target_sparsity`` budget's
    target is the plan fraction. Anything else fails when the step is built:
    a guessed p would mis-size the capacity (truncation, or a padded wire
    that loses to pack2)."""
    if golomb_p is not None:
        p = float(golomb_p)
    elif cfg.budget.kind == "target_sparsity":
        p = float(cfg.budget.value)
    else:
        raise ValueError(
            f"the golomb wire needs a plan-time nonzero fraction to size its static "
            f"capacity: set the step config's golomb_p, or use a budget of kind "
            f"'target_sparsity' (whose target is the plan fraction). Budget kind "
            f"{cfg.budget.kind!r} carries no nnz fraction to plan against.")
    if not 0.0 < p < 1.0:
        raise ValueError(f"golomb plan fraction must be in (0,1), got {p}")
    return p


def resolve_ring_chunk_rows(ring_chunk_rows: Optional[int],
                            vote_impl: Optional[str]) -> Optional[int]:
    """The ring knob, checked when the step is built: None stays monolithic;
    anything else needs the gather impl and a positive multiple of the
    sublane tile. The psum and hier impls reduce without a gathered tensor,
    so a ring request there is refused, not dropped."""
    if ring_chunk_rows is None:
        return None
    if vote_impl != "allgather_packed":
        raise ValueError(
            f"ring_chunk_rows={ring_chunk_rows!r} needs vote_impl='allgather_packed' (the "
            f"ring chunks a gathered payload; vote_impl={vote_impl!r} has none): drop the "
            f"ring knob or switch the vote wire")
    r = int(ring_chunk_rows)
    if r <= 0 or r % SUBLANE_PAD != 0:
        raise ValueError(
            f"ring_chunk_rows must be a positive multiple of the sublane tile "
            f"({SUBLANE_PAD}), got {ring_chunk_rows!r}; collectives.DEFAULT_RING_CHUNK_ROWS "
            f"is the default")
    return r


def broadcast_quorum(quorum, like_tree):
    """Widen the server quorum deadband to a per-leaf tree shaped like
    ``like_tree``. ``quorum`` is a positive int (every leaf) or a tree prefix
    of ``like_tree`` (dicts and tuples) whose leaves are positive ints;
    validated eagerly, so a malformed quorum fails when the step is built."""
    def check(q):
        if isinstance(q, bool) or not isinstance(q, int) or q < 1:
            raise ValueError(f"quorum entries must be ints >= 1, got {q!r} "
                             f"({type(q).__name__})")
        return q

    def fill(q, sub):
        if isinstance(sub, dict):
            return {k: fill(q, v) for k, v in sub.items()}
        if isinstance(sub, (list, tuple)):
            return type(sub)(fill(q, v) for v in sub)
        return q

    def walk(q, sub):
        if isinstance(q, dict):
            if not isinstance(sub, dict) or set(q) != set(sub):
                raise ValueError(f"quorum tree is not a prefix of the parameter tree: "
                                 f"keys {sorted(q) if isinstance(q, dict) else q} against "
                                 f"{sorted(sub) if isinstance(sub, dict) else type(sub)}")
            return {k: walk(q[k], sub[k]) for k in sub}
        if isinstance(q, (list, tuple)):
            if not isinstance(sub, (list, tuple)) or len(q) != len(sub):
                raise ValueError("quorum tree is not a prefix of the parameter tree: "
                                 f"a sequence of {len(q)} against {type(sub).__name__}")
            return type(sub)(walk(a, b) for a, b in zip(q, sub))
        return fill(check(q), sub)

    return walk(quorum, like_tree)


def check_participation_server(server: str, compressor: str) -> None:
    """Build-time gate for elastic participation: the weighted,
    participation-normalized vote covers the majority-vote deadband
    (``|sum w_m sign_m| >= q_frac * W``) and the mean server (divide by the
    realized participation W instead of |S|). ``scaled_sign_ef`` keeps a
    server-side residual calibrated against the full fleet's mean delta, which
    cannot be re-normalized to a shifting reporting set, so it fails here."""
    if server == "scaled_sign_ef":
        raise ValueError(
            f"elastic participation (a ParticipationSpec) is incompatible with server "
            f"'scaled_sign_ef' (compressor {compressor!r}): the server-side EF residual "
            f"is calibrated against the full fleet's mean delta and cannot be "
            f"participation-normalized per round. Use server='majority_vote' or 'mean'.")


def needs_shared_linf(cfg: "CompressionConfig") -> bool:
    """Must the worker L-inf norms be max-reduced before compressing?"""
    return (get_spec(cfg.compressor).scale_protocol == "shared_max"
            or cfg.budget.kind == "linf_share")


def local_budget_value(cfg: "CompressionConfig") -> float:
    """B_l for the tau inner steps of Alg. 2: cfg.local_budget >
    cfg.budget.local_value > the uplink B when fixed > 1.0."""
    if cfg.local_budget is not None:
        return float(cfg.local_budget)
    if cfg.budget.local_value is not None:
        return float(cfg.budget.local_value)
    return float(cfg.budget.value) if cfg.budget.kind == "fixed" else 1.0


def local_step_config(cfg: "CompressionConfig") -> "CompressionConfig":
    """Config for the inner (Alg. 2) local steps: sparsign at fixed B_l."""
    return dataclasses.replace(
        cfg, compressor="sparsign",
        budget=BudgetConfig(kind="fixed", value=local_budget_value(cfg)),
        local_steps=1)


@dataclasses.dataclass(frozen=True)
class LeafSlice:
    """A model rank's slice of a leaf (tensor parallelism): its counter map
    ``(run, leaf_run, offset)`` (``kernels.common.counter_index``: the slice
    draws the whole leaf's counters), the whole leaf's coordinate count, and
    the whole leaf's statistics that compressing the slice reads
    (``leaf_slices``): the float32 sum of squares, sum of |g| or L-inf
    (``compressors.LEAF_STATS``), and the ``target_sparsity`` budget solved
    on the whole leaf."""

    counter_map: tuple
    numel: int
    sum_sq: Optional[torch.Tensor] = None
    abs_sum: Optional[torch.Tensor] = None
    linf: Optional[torch.Tensor] = None
    budget: Optional[torch.Tensor] = None


def leaf_statistics(cfg: "CompressionConfig") -> tuple:
    """The whole-leaf statistics (``compressors.LEAF_STATS``' names) that
    compressing a model rank's slice reads: the L2 budget's sum of squares,
    or the local scale's statistic (scaled sign's L1, 1-bit QSGD's L2 or
    L-inf, qsgd8's L2). A shared-max row reads the step's shared L-inf."""
    spec = get_spec(cfg.compressor)
    if spec.scale_protocol == "local_norm":
        return (LEAF_SCALES[spec.local_scale][0],)
    if spec.scale_protocol == "none" and cfg.budget.kind == "l2_norm":
        return ("sum_sq",)
    return ()


def leaf_slices(cfg: "CompressionConfig", parts, maps, numel: int, *, psum: Callable,
                pmax: Callable) -> list:
    """The ``LeafSlice`` of each of this process's model ranks' slices
    ``parts`` of one leaf (``maps``: their counter maps). Each whole-leaf
    statistic is reduced over 'model' from the slices' partials: ``psum``
    the ordered all-reduce (rank order), ``pmax`` the max, each taking one
    partial a local rank (``collectives.tp_sum``, ``tp_max``), so every rank
    of a worker holds the same bits. A ``target_sparsity`` budget is solved
    on the whole leaf (``budgets.solve_budget_for_sparsity_slices``)."""
    stats = {}
    for name in leaf_statistics(cfg):
        partial, how = LEAF_STATS[name]
        stats[name] = (psum if how == "sum" else pmax)([partial(x) for x in parts])
    spec = get_spec(cfg.compressor)
    if spec.scale_protocol == "none" and cfg.budget.kind == "target_sparsity":
        stats["budget"] = solve_budget_for_sparsity_slices(parts, cfg.budget.value, numel,
                                                           psum=psum, pmax=pmax)
    return [LeafSlice(tuple(m), numel, **stats) for m in maps]


def is_batched(seed) -> bool:
    """Is ``seed`` a 1-D sequence of per-row seeds (a batch of messages)?"""
    return torch.as_tensor(seed).dim() == 1


def compress_leaf(
    g: torch.Tensor,
    cfg: "CompressionConfig",
    seed,
    counter_base=0,
    *,
    shared_linf=None,
    backend: Optional[str] = None,
    wire=None,
    leaf_slice: Optional[LeafSlice] = None,
) -> CompressedGrad:
    """Q(g, B): one worker's uplink message, or every worker's at once when
    ``seed`` is a 1-D sequence of per-row seeds and g is (workers, ...).

    ``leaf_slice``: g is a model rank's slice of a leaf (tensor
    parallelism). Its symbols are the whole leaf's at the same coordinates:
    the kernels draw the whole leaf's counters (the counter map), the
    budgets and local scales read the whole leaf's statistics (``LeafSlice``),
    and a golomb message holds as many nonzeros as the whole leaf's would.

    ``wire`` (a ``VoteWire``, one message only) selects the message's
    wire-native format. On the ``pack2`` wire ``values`` is the (rows, 128)
    uint8 packed canonical view: on the ``cuda`` backend the spec's fused
    kernel writes it in one pass, or, for a spec without one, the compress
    kernel and then the ``pack2bit`` kernel; the plain versions compress,
    then pack, the same bytes. On the ``golomb`` wire ``values`` is the
    (rows, 128) uint8 coded stream at the wire's plan fraction ``wire.p``:
    the fused kernel on the card (or, for a golomb row without one, the
    compress kernel and then the ``golomb_pack`` kernel), the plain versions
    on the CPU. On the ``pack8`` wire ``values`` is the (rows, 512) int8
    canonical view of the levels and ``scale`` the message's decode scale:
    the fused ``qsgd8_pack8`` kernel on the card, the levels' canonical view
    on the CPU.

    A spec with a kernel op takes the CUDA kernel on the ``cuda`` backend;
    everything else runs the plain version (chunked for the counter-indexed
    families). ``shared_linf`` (the max of the workers' L-inf norms) feeds the
    ``linf_share`` budget and the ``shared_max`` scale; without it TernGrad
    takes each message's own norm, as the JAX engine does outside a mesh.

    The kernel's param is the spec's decode scale where it has one, else the
    budget. A scale-carrying batch returns ``scale`` of shape (workers, 1,
    ...): each row's own norm, or the shared max for every row. Scales are
    device reductions, never host reads."""
    backend = resolve_backend(backend, g)
    spec = get_spec(cfg.compressor)
    rows = is_batched(seed)
    wire_fmt = wire.native_format if wire is not None else None
    want_packed = wire_fmt in ("pack2", "golomb", "pack8")
    if want_packed and spec.wire_format != wire_fmt:
        carries = "int8 sign*level" if wire_fmt == "pack8" else "ternary"
        raise ValueError(f"the {wire_fmt!r} wire carries {carries} messages only; compressor "
                         f"{cfg.compressor!r} declares wire format {spec.wire_format!r}")
    if want_packed and rows:
        raise ValueError("a packed wire message is one worker's: pass one seed")
    # the golomb wire's capacity is sized by its plan fraction: the encoders
    # take the same p, or the message's shape disagrees with the ledger
    fused_kwargs = {"p": wire.p} if wire_fmt == "golomb" else {}
    cmap = {}
    if leaf_slice is not None:
        if rows:
            raise ValueError("a model rank's slice is one message: pass one seed")
        cmap = {"counter_map": tuple(leaf_slice.counter_map)}
        if wire_fmt == "golomb":   # the slice's capacity: the whole leaf's nonzeros
            fused_kwargs["leaf_n"] = leaf_slice.numel
    if leaf_slice is not None and spec.scale_protocol == "local_norm":
        # the whole leaf's local scale, from its statistic reduced over 'model'
        stat, from_stat = LEAF_SCALES[spec.local_scale]
        scale = from_stat(getattr(leaf_slice, stat), leaf_slice.numel, g.dtype)
    else:
        scale = spec.resolve_scale(g, shared_linf, rows=rows)
    if scale is None:
        param = resolve_budget(cfg.budget, g, shared_linf=shared_linf, rows=rows,
                               leaf_slice=leaf_slice)
        msg_scale = torch.ones((), dtype=torch.float32, device=g.device)
    else:
        param = msg_scale = scale
        if rows:  # one scale per message, broadcast against (workers, ...)
            msg_scale = scale.expand(g.shape[0]).reshape((g.shape[0],) + (1,) * (g.dim() - 1))
    if want_packed and backend == "cuda" and spec.fused_pack_op is not None:
        return CompressedGrad(
            values=spec.fused_pack_op(g, param, seed, counter_base, **fused_kwargs, **cmap),
            scale=msg_scale)
    if backend == "cuda" and spec.kernel_op is not None:
        vals = spec.kernel_op(g, param, seed, counter_base, **cmap)
    elif spec.chunkable and not cmap:
        vals = chunked_values(spec.values, g, param, seed, counter_base)
    else:
        vals = spec.values(g, param, seed, counter_base, **cmap)
    if wire_fmt == "golomb":
        # the two-pass chain: the golomb_pack kernel on the card
        leaf_n = fused_kwargs.get("leaf_n")
        vals = (golomb_pack_op(vals, p=wire.p, leaf_n=leaf_n) if backend == "cuda"
                else golomb_encode_ref(vals, p=wire.p, leaf_n=leaf_n))
    elif wire_fmt == "pack8":
        # the pack8 payload is the canonical int8 view of the levels
        vals, _ = to_2d(vals.reshape(-1))
    elif want_packed:
        # the two-pass chain: the pack2bit kernel on the card
        if backend == "cuda":
            vals = pack2bit_op(vals)
        else:
            view, _ = to_2d(vals.reshape(-1))
            vals = pack2bit_ref(view)
    return CompressedGrad(values=vals, scale=msg_scale)


def compress_leaf_rows(
    g: torch.Tensor,
    cfg: "CompressionConfig",
    seed,
    counter_base=0,
    *,
    rows: int,
    shared_linf=None,
    backend: Optional[str] = None,
    wire=None,
) -> CompressedGrad:
    """``compress_leaf`` laid out as a bucket slot: the wire-native message
    as exactly ``rows`` payload rows (``bucketing.as_rows``). The compression
    is the per-leaf one byte for byte; packed views only drop their sublane
    padding rows and leaf-shaped votes pad into rows."""
    from repro_torch.dist import bucketing  # the dist layer imports this module
    msg = compress_leaf(g, cfg, seed, counter_base, shared_linf=shared_linf,
                        backend=backend, wire=wire)
    return CompressedGrad(values=bucketing.as_rows(msg.values, wire.native_format, rows),
                          scale=msg.scale)


def ef_l1_partial(vote_sum: torch.Tensor, ef: torch.Tensor, n_sel) -> torch.Tensor:
    """sum |vote_sum / n_sel + ef| in float32: ``scaled_sign_ef``'s L1 of one
    slice of a leaf, as ``server_apply`` computes it, for a caller that
    reduces the slices' partials itself (tensor parallelism)."""
    n = torch.clamp(device_tensor(n_sel, ef), min=1.0)
    return torch.sum(torch.abs(vote_sum.to(torch.float32) / n + ef.to(torch.float32)))


def server_apply(
    p: torch.Tensor,
    vote_sum: torch.Tensor,
    cfg: "CompressionConfig",
    *,
    lr: float,
    ef=None,
    n_sel=None,
    server: Optional[str] = None,
    scale=None,
    leaf_size: Optional[int] = None,
    l1_reduce: Optional[Callable] = None,
    quorum: int = 1,
    part_total=None,
    q_frac: Optional[float] = None,
    backend: Optional[str] = None,
):
    """C(sum of worker messages) [+ EF] + SGD for one leaf, or this
    process's slice of one.

    Returns ``(new_p, new_ef)`` with ``new_p`` in ``p.dtype``.

    - ``majority_vote``: p - lr * sign(vote_sum). Integer votes take the fused
      ``vote_update`` kernel; float votes (the FL simulation's decoded-sum
      wire) take the sign directly, as the JAX engine does, since the integer
      kernel would truncate fractional sums. ``ef`` passes through.
    - ``scaled_sign_ef``: acc = vote_sum / n_sel + ef; scale = ||acc||_1 /
      ``leaf_size`` (default: acc's size), reduced on the device; update =
      scale * sign(acc) and new_ef = acc - update through the fused
      ``ef_server`` kernel. On a slice of a leaf (the streamed trainer)
      ``l1_reduce`` takes |acc| and returns the whole leaf's L1: JAX's hook
      sums each shard's partial L1 over the FSDP axis; the port's is given
      the element-wise |acc| because one process holds several workers'
      shards, and it folds their partials in worker order.
    - ``mean``: p - lr * scale * vote_sum / n_sel.

    ``lr`` is a host scalar.

    Elastic participation (``part_total`` + ``q_frac``): ``vote_sum`` is the
    weighted float32 vote sum_m w_m * msg_m and ``part_total`` the realized
    participation W = sum over reporters of w_m (a device scalar, or one value
    per coordinate). The majority vote steps only where ``|vote_sum| >=
    q_frac * W``, through the fused ``weighted_vote_update`` kernel. A mean
    server takes W as its ``n_sel`` instead. ``scaled_sign_ef`` refuses
    elastic input (``check_participation_server``).
    """
    backend = resolve_backend(backend, p)
    rule = server if server is not None else cfg.server
    if part_total is not None:
        check_participation_server(rule, cfg.compressor)
    lr32 = device_tensor(float(lr), p)

    def n_sel_f32():
        return torch.clamp(device_tensor(n_sel, p), min=1.0)

    if rule == "majority_vote":
        if part_total is not None:
            if q_frac is None:
                raise ValueError(
                    "elastic majority vote needs q_frac (the quorum as a fraction of "
                    "realized participation) next to part_total")
            wv = vote_sum.to(torch.float32)
            if backend == "cuda":
                new_p = weighted_vote_update_op(p, wv, part_total, lr, q_frac=float(q_frac))
            else:
                new_p = weighted_vote_update_ref(p, wv, part_total, lr, float(q_frac))
        elif not vote_sum.is_floating_point():
            if backend == "cuda":
                new_p = vote_update_op(p, vote_sum, lr, quorum=quorum)
            else:
                new_p = vote_update_ref(p, vote_sum, lr, quorum=quorum)
        else:
            v = vote_sum
            step = jnp_sign(v)
            if quorum > 1:
                step = torch.where(torch.abs(v) >= quorum, step, torch.zeros_like(step))
            new_p = (p.to(torch.float32) - lr32 * step.to(torch.float32)).to(p.dtype)
        return new_p, ef

    if rule == "mean":
        if n_sel is None:
            raise ValueError("mean server needs n_sel (|S|)")
        upd = vote_sum.to(torch.float32) / n_sel_f32()
        if scale is not None:
            upd = upd * device_tensor(scale, p)
        return (p.to(torch.float32) - lr32 * upd).to(p.dtype), ef

    if rule == "scaled_sign_ef":
        if ef is None or n_sel is None:
            raise ValueError("scaled_sign_ef needs ef and n_sel")
        mean_delta = vote_sum.to(torch.float32) / n_sel_f32()
        eff = ef.to(torch.float32)
        mag = torch.abs(mean_delta + eff)
        part = l1_reduce(mag) if l1_reduce is not None else torch.sum(mag)
        size = leaf_size if leaf_size is not None else mean_delta.numel()
        srv_scale = part / device_tensor(float(size), p)
        if backend == "cuda":
            upd, new_ef = ef_server_op(mean_delta, eff, srv_scale)
        else:
            upd, new_ef = ef_server_ref(mean_delta, eff, srv_scale)
        return (p.to(torch.float32) - lr32 * upd).to(p.dtype), new_ef

    raise ValueError(f"unknown server rule {rule!r}; known: {SERVER_RULES}")
