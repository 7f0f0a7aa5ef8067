"""Gradient compressors and the ``CompressorSpec`` registry, the port of
``repro.core.compressors``: the paper's ``sparsign`` (Def. 1), the Table 1-2
baselines of §6 / Appendix B (sign, scaled sign, noisy sign, 1-bit QSGD in
L2 and L-inf, TernGrad), ``sparsign_golomb`` (sparsign on the Golomb/Rice
entropy-coded wire), the FedCom 8-bit QSGD ``qsgd8`` (the pack8 wire) and the
uncompressed ``identity``: every row of the JAX table.

Values functions share the normalized signature
``(g, param, seed, counter_base) -> values``, where ``seed`` is one stream
seed or a 1-D tensor of per-worker seeds for g of shape (workers, ...), and
``param`` is the budget (sigma for noisy sign) of a scale-free row, or the
decode scale of a scale-carrying row: a scalar or one value per row.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import torch

from repro_torch.core import prng
from repro_torch.kernels.golomb.ops import sparsign_golomb_op
from repro_torch.kernels.pack8.ops import qsgd8_op, qsgd8_pack8_op
from repro_torch.kernels.pack8.ref import QSGD8_LEVELS, qsgd8_levels_ref
from repro_torch.kernels.sparsign.ops import sparsign_op
from repro_torch.kernels.sparsign_pack2bit.ops import sparsign_pack2bit_op
from repro_torch.kernels.ternary.ops import (noisy_sign_op, noisy_sign_pack2bit_op, sign_op,
                                             sign_pack2bit_op, stochastic_ternary_op,
                                             stochastic_ternary_pack2bit_op)
from repro_torch.kernels.ternary.ref import as_rows, ternary_compress_ref


@dataclasses.dataclass(frozen=True)
class CompressedGrad:
    """values: int8 ternary {-1,0,+1} or a float payload. scale: the decode
    multiplier: 1.0 for the scale-free rows, a norm for the scaled ones, of
    shape (workers, 1, ...) for a batch of messages with their own norms."""

    values: torch.Tensor
    scale: torch.Tensor

    def decode(self) -> torch.Tensor:
        return self.values.to(torch.float32) * self.scale


# ---------------------------------------------------------------------------
# Local-scale resolvers (CompressorSpec.local_scale): g -> float32 scale,
# 0-d for one message, (workers,) with rows=True for g of shape (workers, ...)
# ---------------------------------------------------------------------------

def _flat(g: torch.Tensor, rows: bool, dtype=torch.float32) -> torch.Tensor:
    gf = g.to(dtype)
    return gf.reshape(gf.shape[0], -1) if rows else gf.reshape(1, -1)


def _scale_l1_mean(g: torch.Tensor, rows: bool = False) -> torch.Tensor:
    """||g||_1 / d: scaled signSGD (Karimireddy et al. 2019). The sum is
    taken in g's dtype, then cast, as the JAX resolver takes it."""
    flat = _flat(g, rows, g.dtype)
    d = torch.full((), float(flat.shape[1]), dtype=torch.float32, device=g.device)
    s = torch.sum(torch.abs(flat), dim=1).to(torch.float32) / d
    return s if rows else s[0]


def _scale_l2(g: torch.Tensor, rows: bool = False) -> torch.Tensor:
    """||g||_2: 1-bit L2 QSGD."""
    s = torch.linalg.vector_norm(_flat(g, rows), dim=1)
    return s if rows else s[0]


def _scale_linf(g: torch.Tensor, rows: bool = False) -> torch.Tensor:
    """||g||_inf: 1-bit L-inf QSGD and (local) TernGrad."""
    s = torch.amax(torch.abs(_flat(g, rows)), dim=1)
    return s if rows else s[0]


def _scale_qsgd(g: torch.Tensor, rows: bool = False, *, s: int = QSGD8_LEVELS) -> torch.Tensor:
    """max(||g||_2, eps) / s: the per-level decode scale of s-level QSGD."""
    return torch.clamp(_scale_l2(g, rows), min=1e-12) / float(s)


#: the L2-based local scales as functions of the message's sum of squares: a
#: model rank's slice of a leaf takes the whole leaf's, reduced over 'model'
SCALE_FROM_SUM_SQ = {
    _scale_l2: torch.sqrt,
    _scale_qsgd: lambda sum_sq: torch.clamp(torch.sqrt(sum_sq), min=1e-12) / float(QSGD8_LEVELS),
}


# ---------------------------------------------------------------------------
# Normalized value functions (CompressorSpec.values): the plain versions of the
# kernel ops, argument for argument
# ---------------------------------------------------------------------------

_sparsign_values = partial(ternary_compress_ref, rule="sparsign")
_sign_values = partial(ternary_compress_ref, rule="sign")
_noisy_sign_values = partial(ternary_compress_ref, rule="noisy_sign")
_stochastic_ternary_values = partial(ternary_compress_ref, rule="stochastic_ternary")


def _identity_values(g, param, seed, counter_base):
    return g


# ---------------------------------------------------------------------------
# Public compressors (Def. 1 + Appendix B): thin scale-wrapping shims, one
# message each, over the ops (the kernel on the card, the plain version on
# the CPU)
# ---------------------------------------------------------------------------

def _one(x) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32, device=x.device)


def sparsign(g, *, budget, seed, counter_base=0) -> CompressedGrad:
    """Magnitude-aware stochastic ternarization (Def. 1):
    Q(g_i) = sign(g_i) w.p. min(|g_i| * B_i, 1) else 0. Scale-free."""
    return CompressedGrad(values=sparsign_op(g, budget, seed, counter_base), scale=_one(g))


def sign_compressor(g, *, budget=None, seed=None, counter_base=0) -> CompressedGrad:
    """signSGD (Bernstein et al. 2018): deterministic sign; sign(0) = 0. The
    rule draws nothing, so the seed is not read."""
    values = sign_op(g, 0.0, 0 if seed is None else seed, counter_base)
    return CompressedGrad(values=values, scale=_one(g))


def scaled_sign(g, *, budget=None, seed=None, counter_base=0) -> CompressedGrad:
    """Scaled signSGD (Karimireddy et al. 2019): (||g||_1 / d) * sign(g)."""
    return CompressedGrad(values=sign_op(g, 0.0, 0 if seed is None else seed, counter_base),
                          scale=_scale_l1_mean(g))


def noisy_sign(g, *, budget=1.0, seed=0, counter_base=0) -> CompressedGrad:
    """Noisy signSGD (Chen et al. 2020a): sign(g + n), n ~ N(0, sigma^2);
    ``budget`` is sigma. Gaussian noise by Box-Muller from two folded
    counter streams."""
    return CompressedGrad(values=noisy_sign_op(g, budget, seed, counter_base), scale=_one(g))


def qsgd_1bit_l2(g, *, budget=None, seed=0, counter_base=0) -> CompressedGrad:
    """1-bit L2 QSGD (Alistarh et al. 2017, s = 1):
    ||g||_2 * sign * Bernoulli(|g| / ||g||_2)."""
    norm = _scale_l2(g)
    return CompressedGrad(values=stochastic_ternary_op(g, norm, seed, counter_base), scale=norm)


def qsgd_1bit_linf(g, *, budget=None, seed=0, counter_base=0) -> CompressedGrad:
    """1-bit L-inf QSGD: ||.||_2 replaced by ||.||_inf."""
    norm = _scale_linf(g)
    return CompressedGrad(values=stochastic_ternary_op(g, norm, seed, counter_base), scale=norm)


def terngrad(g, *, budget=None, seed=0, counter_base=0, shared_max=None) -> CompressedGrad:
    """TernGrad (Wen et al. 2017): s_t * sign(g) * Bernoulli(|g| / s_t), with
    s_t the magnitude-shared max_m ||g_m||_inf when given, else the local
    L-inf norm (single-worker TernGrad)."""
    s_t = (torch.as_tensor(shared_max, dtype=torch.float32, device=g.device)
           if shared_max is not None else _scale_linf(g))
    return CompressedGrad(values=stochastic_ternary_op(g, s_t, seed, counter_base), scale=s_t)


def qsgd8(g, *, budget=None, seed=0, counter_base=0) -> CompressedGrad:
    """FedCom-style 8-bit QSGD: 1 sign bit + 7 level bits, s = 127. The
    signed stochastic level rides the pack8 wire as one int8 byte a
    coordinate (levels clip at 127); the level rule is
    ``kernels.pack8.ref.qsgd8_levels_ref``, the kernel's plain version."""
    scale = qsgd8_scale(g)
    return CompressedGrad(values=qsgd8_op(g, scale, seed, counter_base), scale=scale)


def qsgd8_scale(g: torch.Tensor) -> torch.Tensor:
    """The qsgd8 decode scale max(||g||_2, eps) / 127, for callers that
    quantize outside the registry (the serving replica's 8-bit downlink)."""
    return _scale_qsgd(g)


def identity(g, *, budget=None, seed=None, counter_base=0) -> CompressedGrad:
    """Uncompressed baseline (D-SGD)."""
    return CompressedGrad(values=g, scale=_one(g))


# ---------------------------------------------------------------------------
# The CompressorSpec registry
# ---------------------------------------------------------------------------

#: scale protocols: how the decode-time scale is produced.
#:   none       -- scale-free (scale 1); the param fed to the kernels is the budget
#:   local_norm -- each worker's own norm (local_scale)
#:   shared_max -- TernGrad's magnitude sharing: one max_m ||g_m||_inf for all
SCALE_PROTOCOLS = ("none", "local_norm", "shared_max")
#: what the aggregated message means to the server: scale-free votes, votes
#: times a scale, or a non-ternary payload
SERVER_DECODES = ("sign", "scaled_sign", "dequant")
#: the uplink bit models ``core.encoding.baseline_bits_per_round`` bills a
#: row's messages under (``CompressorSpec.uplink_bits``)
UPLINK_BIT_MODELS = ("dense_sign", "golomb_ternary", "level8", "fp32")
#: the uplink payload format a row's messages take on a packed wire: the flat
#: 2-bit ternary codebook, the Golomb stream, the 8-bit levels, or floats
#: (which ride the decoded psum)
WIRE_FORMATS = ("pack2", "golomb", "pack8", "float")


@dataclasses.dataclass(frozen=True)
class CompressorSpec:
    """One row of the compressor table. ``api`` is the public compressor;
    ``values`` the plain version and ``kernel_op`` the op that launches the
    CUDA kernel for a tensor on the card (argument for argument the same).
    ``wire_format`` is the payload format on a packed wire and
    ``fused_pack_op`` the op that compresses straight into it (one kernel from
    gradient to wire bytes), both as the JAX table has them."""

    name: str
    api: Callable
    values: Callable
    is_ternary: bool
    scale_protocol: str = "none"
    local_scale: Optional[Callable] = None   # (g, rows) -> float32 scale(s)
    kernel_op: Optional[Callable] = None
    server_decode: str = "sign"
    chunkable: bool = False
    uplink_bits: str = "dense_sign"
    wire_format: str = "pack2"
    fused_pack_op: Optional[Callable] = None

    def __post_init__(self):
        if self.scale_protocol not in SCALE_PROTOCOLS:
            raise ValueError(f"{self.name}: unknown scale protocol {self.scale_protocol!r}")
        if self.server_decode not in SERVER_DECODES:
            raise ValueError(f"{self.name}: unknown server decode {self.server_decode!r}")
        if (self.scale_protocol == "none") != (self.local_scale is None):
            raise ValueError(f"{self.name}: a local_scale goes with a scale protocol")
        if self.wire_format not in WIRE_FORMATS:
            raise ValueError(f"{self.name}: unknown wire format {self.wire_format!r}")
        if (self.wire_format in ("pack2", "golomb")) != self.is_ternary:
            raise ValueError(f"{self.name}: a ternary row rides a ternary wire format")
        if self.fused_pack_op is not None and self.wire_format == "float":
            raise ValueError(f"{self.name}: a fused pack op needs a packed wire format")

    @property
    def scale_shared(self) -> bool:
        """Is the decode scale the same on every worker (so ternary votes can
        ride the integer or packed wire even under a mean server)?"""
        return self.scale_protocol in ("none", "shared_max")

    def resolve_scale(self, g: torch.Tensor, shared_linf=None, *,
                      rows: bool = False) -> Optional[torch.Tensor]:
        """The float32 decode scale of ``g``, or None for a scale-free row:
        the shared max when the protocol is ``shared_max`` and it is given,
        else the local norm (per row with ``rows``). Scales are device
        reductions, never host reads."""
        if self.scale_protocol == "none":
            return None
        if self.scale_protocol == "shared_max" and shared_linf is not None:
            return torch.as_tensor(shared_linf, dtype=torch.float32, device=g.device)
        return self.local_scale(g, rows)


SPECS: dict[str, CompressorSpec] = {spec.name: spec for spec in (
    CompressorSpec(
        name="sparsign", api=sparsign, values=_sparsign_values, is_ternary=True,
        kernel_op=sparsign_op, fused_pack_op=sparsign_pack2bit_op, chunkable=True,
        uplink_bits="golomb_ternary"),
    CompressorSpec(
        # the same Def. 1 compressor as 'sparsign' (values, seeds, budget) on
        # the entropy-coded wire: Rice-coded zero runs and sign bits at a
        # plan-time capacity instead of the flat 2-bit codebook
        name="sparsign_golomb", api=sparsign, values=_sparsign_values, is_ternary=True,
        kernel_op=sparsign_op, fused_pack_op=sparsign_golomb_op, chunkable=True,
        wire_format="golomb", uplink_bits="golomb_ternary"),
    CompressorSpec(
        name="sign", api=sign_compressor, values=_sign_values, is_ternary=True,
        kernel_op=sign_op, fused_pack_op=sign_pack2bit_op),
    CompressorSpec(
        name="scaled_sign", api=scaled_sign, values=_sign_values, is_ternary=True,
        scale_protocol="local_norm", local_scale=_scale_l1_mean, kernel_op=sign_op,
        fused_pack_op=sign_pack2bit_op, server_decode="scaled_sign"),
    CompressorSpec(
        name="noisy_sign", api=noisy_sign, values=_noisy_sign_values, is_ternary=True,
        kernel_op=noisy_sign_op, fused_pack_op=noisy_sign_pack2bit_op, chunkable=True),
    CompressorSpec(
        name="qsgd_1bit_l2", api=qsgd_1bit_l2, values=_stochastic_ternary_values,
        is_ternary=True, scale_protocol="local_norm", local_scale=_scale_l2,
        kernel_op=stochastic_ternary_op, fused_pack_op=stochastic_ternary_pack2bit_op,
        server_decode="scaled_sign", chunkable=True,
        uplink_bits="golomb_ternary"),
    CompressorSpec(
        name="qsgd_1bit_linf", api=qsgd_1bit_linf, values=_stochastic_ternary_values,
        is_ternary=True, scale_protocol="local_norm", local_scale=_scale_linf,
        kernel_op=stochastic_ternary_op, fused_pack_op=stochastic_ternary_pack2bit_op,
        server_decode="scaled_sign", chunkable=True,
        uplink_bits="golomb_ternary"),
    CompressorSpec(
        name="terngrad", api=terngrad, values=_stochastic_ternary_values,
        is_ternary=True, scale_protocol="shared_max", local_scale=_scale_linf,
        kernel_op=stochastic_ternary_op, fused_pack_op=stochastic_ternary_pack2bit_op,
        server_decode="scaled_sign", chunkable=True,
        uplink_bits="golomb_ternary"),
    CompressorSpec(
        # FedCom 8-bit baseline: 1 sign bit + 7 level bits (s = 127), so one
        # worker message is 1 B a coordinate on the pack8 wire + one scale
        name="qsgd8", api=qsgd8, values=qsgd8_levels_ref, is_ternary=False,
        scale_protocol="local_norm", local_scale=_scale_qsgd, kernel_op=qsgd8_op,
        fused_pack_op=qsgd8_pack8_op, server_decode="dequant", chunkable=True,
        wire_format="pack8", uplink_bits="level8"),
    CompressorSpec(
        name="identity", api=identity, values=_identity_values, is_ternary=False,
        server_decode="dequant", wire_format="float", uplink_bits="fp32"),
)}

def get_spec(name: str) -> CompressorSpec:
    try:
        return SPECS[name]
    except KeyError:
        raise KeyError(f"unknown compressor {name!r}; known: {sorted(SPECS)}") from None


# ---------------------------------------------------------------------------
# Chunked and tree-level application
# ---------------------------------------------------------------------------

def chunked_values(values_fn, g, param, seed, counter_base=0, max_chunk: int = 1 << 23):
    """Apply a counter-indexed values function in column chunks, which bounds
    the plain version's int64 counter and uniform buffers to ``max_chunk``
    elements. Stream-identical to one call: the counter is the column index."""
    rows, _ = as_rows(g, seed)
    if rows.numel() <= max_chunk:
        return values_fn(g, param, seed, counter_base)
    step = max(1, max_chunk // rows.shape[0])
    parts = [values_fn(rows[:, s:s + step].contiguous(), param, seed, int(counter_base) + s)
             for s in range(0, rows.shape[1], step)]
    return torch.cat([p.reshape(rows.shape[0], -1) for p in parts], dim=1).reshape(g.shape)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list / tuple, in ``jax.tree_util``'s
    order (dict keys sorted). ``None`` is an empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in ``tree_leaves``'s
    order."""
    it = iter(leaves)

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: walk(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(x) for x in t)
        return next(it)

    out = walk(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def leaf_counter_bases(tree) -> list[int]:
    """Starting logical-coordinate index of each leaf of a gradient tree, so
    that per-leaf compression draws from disjoint slices of one stream."""
    bases, acc = [], 0
    for leaf in tree_leaves(tree):
        bases.append(acc)
        acc += int(leaf.numel())
    return bases


def compress_tree(grads, *, name: str, budget, seed, extra_salt: int = 0):
    """Apply a compressor leaf-wise with disjoint counter ranges; returns a
    tree of CompressedGrad shaped like ``grads``."""
    fn = get_spec(name).api
    leaf_seed = prng.fold_seed_int(int(seed), extra_salt)
    bases = iter(leaf_counter_bases(grads))

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(item) for item in tree)
        return fn(tree, budget=budget, seed=leaf_seed, counter_base=next(bases))

    return walk(grads)
