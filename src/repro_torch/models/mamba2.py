"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) mixer, the port of
``repro.models.mamba2``.

The minimal SSD algorithm: a chunked scan whose intra-chunk work is batched
products (``torch.einsum`` and ``torch.matmul``) and whose only sequential
piece is the O(S/Q) recurrence between chunks, a Python loop over the chunks
(JAX's ``lax.scan``). As in the JAX package the packed in_proj is split into
``w_z``, ``w_x``, ``w_bc`` and ``w_dt``, B and C form a single group, the
gated RMSNorm is the RMSNorm of the gated output, and the D term is per
head. ``A_log``, ``dt_bias`` and ``D`` are float32 at every dtype.

The three-operand einsums of the JAX package are written here as a product
then a two-operand contraction, so the order of float sums differs from
XLA's: parity with JAX holds to a tolerance, not bit for bit. Decode is the
exact O(1) recurrence.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.common import rms_norm


@dataclasses.dataclass(frozen=True)
class MambaDims:
    d_model: int
    d_inner: int        # expand * d_model
    n_heads: int        # d_inner // head_dim
    head_dim: int
    d_state: int        # N
    d_conv: int = 4
    chunk: int = 128


def mamba_param_defs(dims: MambaDims, dtype: torch.dtype) -> dict:
    """name -> (shape, dtype)."""
    di, n, h = dims.d_inner, dims.d_state, dims.n_heads
    return {
        "w_z": ((dims.d_model, di), dtype),
        "w_x": ((dims.d_model, di), dtype),
        "w_bc": ((dims.d_model, 2 * n), dtype),
        "w_dt": ((dims.d_model, h), dtype),
        "conv_x": ((dims.d_conv, di), dtype),
        "conv_bc": ((dims.d_conv, 2 * n), dtype),
        "conv_b_x": ((di,), dtype),
        "conv_b_bc": ((2 * n,), dtype),
        "A_log": ((h,), torch.float32),
        "dt_bias": ((h,), torch.float32),
        "D": ((h,), torch.float32),
        "norm": ((di,), dtype),
        "w_out": ((di, dims.d_model), dtype),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it: max(x, 0) +
    log1p(exp(-|x|)) (torch's own softplus takes another formula)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 init: torch.Tensor | None = None):
    """Depthwise causal conv along the sequence, in float32. x: [B, S, C];
    conv_w: [K, C]. Returns (out [B, S, C] in x's dtype, tail [B, K-1, C]),
    the tail priming the decode ring."""
    k = conv_w.shape[0]
    b, s, c = x.shape
    front = init if init is not None else x.new_zeros((b, k - 1, c))
    xp = torch.cat([front, x], dim=1)
    out = torch.zeros((b, s, c), dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s].to(torch.float32) * conv_w[i].to(torch.float32)
    out = F.silu(out + conv_b.to(torch.float32))
    return out.to(x.dtype), xp[:, s:]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Causal segment sums: out[..., i, j] = sum_{j < k <= i} x[..., k], -inf
    where j > i. The mask is applied before any exp, so exp(-inf) = 0 and
    the backward sends no NaN through the masked entries."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=x.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, torch.full((), float("-inf"), device=x.device))


def ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip, dims: MambaDims, init_state=None):
    """SSD over a full sequence.

    x:     [B, S, H, P] (values)
    dt:    [B, S, H]    (pre-softplus)
    b_mat, c_mat: [B, S, N] (a single group)
    Returns (y [B, S, H, P] float32, final_state [B, H, P, N] float32).
    """
    bsz, s_orig, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(dims.chunk, s_orig)
    pad = (-s_orig) % q
    if pad:
        # dt -> -1e9 makes softplus(dt) = 0: padded steps leave the state as it is
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad), value=-1e9)
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    s = s_orig + pad
    nc = s // q

    dt = _softplus(dt.to(torch.float32))                       # [B, S, H]
    a = -torch.exp(a_log.to(torch.float32))                    # [H]
    da = dt * a[None, None, :]                                 # [B, S, H] log decay
    xdt = x.to(torch.float32) * dt[..., None]

    da_c = da.reshape(bsz, nc, q, h)
    x_c = xdt.reshape(bsz, nc, q, h, p)
    b_c = b_mat.to(torch.float32).reshape(bsz, nc, q, n)
    c_c = c_mat.to(torch.float32).reshape(bsz, nc, q, n)

    # intra-chunk (the diagonal blocks): y[i] = sum_j (C_i . B_j) L[h, i, j] x[j]
    l_mat = torch.exp(_segsum(da_c.transpose(2, 3)))           # [B, nc, H, q, q]
    cb = torch.einsum("bcin,bcjn->bcij", c_c, b_c)             # [B, nc, q, q]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", cb[:, :, None] * l_mat, x_c)

    # chunk-final states: sum_j exp(sum_{k > j} da) B_j x_j
    da_cum = torch.cumsum(da_c, dim=2)                         # [B, nc, q, H]
    decay_to_end = torch.exp(da_cum[:, :, -1:, :] - da_cum)    # [B, nc, q, H]
    chunk_state = torch.einsum("bcjn,bcjhp->bchpn", b_c, decay_to_end[..., None] * x_c)

    # the recurrence between chunks: the state entering each chunk
    chunk_decay = torch.exp(da_cum[:, :, -1, :])               # [B, nc, H]
    state = (init_state if init_state is not None
             else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    states_in = torch.stack(states_in, dim=1)                  # [B, nc, H, P, N]

    # off-diagonal contribution: y_off = C_i . (decay_in * state_in)
    decay_in = torch.exp(da_cum)                               # [B, nc, q, H]
    y_off = torch.einsum("bcin,bchpn->bcihp", c_c, states_in) * decay_in[..., None]

    y = (y_intra + y_off).reshape(bsz, s, h, p)
    y = y + d_skip.to(torch.float32)[None, None, :, None] * x.to(torch.float32)
    if pad:
        y = y[:, :s_orig]
    return y, state


def mamba_forward(params: dict, hidden: torch.Tensor, dims: MambaDims, conv_init=None,
                  ssd_init=None, return_cache: bool = False):
    """The full mixer: projections -> conv -> SSD -> gated norm -> out_proj.

    hidden: [B, S, Dm]; conv_init: [B, K-1, di + 2n]. Returns out [B, S, Dm]
    (and (conv_tail, final_state) with ``return_cache``)."""
    bsz, s, _ = hidden.shape
    di, n = dims.d_inner, dims.d_state
    z = hidden @ params["w_z"]                                 # [B, S, di]
    x_raw = hidden @ params["w_x"]
    bc_raw = hidden @ params["w_bc"]
    dt = (hidden @ params["w_dt"]).to(torch.float32) + params["dt_bias"]

    conv_in_x = conv_init[..., :di] if conv_init is not None else None
    conv_in_bc = conv_init[..., di:] if conv_init is not None else None
    x_conv, tail_x = _causal_conv(x_raw, params["conv_x"], params["conv_b_x"], conv_in_x)
    bc_conv, tail_bc = _causal_conv(bc_raw, params["conv_bc"], params["conv_b_bc"], conv_in_bc)

    x = x_conv.reshape(bsz, s, dims.n_heads, dims.head_dim)
    b_mat, c_mat = bc_conv[..., :n], bc_conv[..., n:]
    y, final_state = ssd_chunked(x, dt, params["A_log"], b_mat, c_mat, params["D"], dims,
                                 ssd_init)
    y = y.reshape(bsz, s, di).to(hidden.dtype)
    y = rms_norm(y * F.silu(z.to(torch.float32)).to(y.dtype), params["norm"])
    out = y @ params["w_out"]
    if return_cache:
        return out, (torch.cat([tail_x, tail_bc], dim=-1), final_state)
    return out


def mamba_decode_step(params: dict, hidden: torch.Tensor, cache, dims: MambaDims):
    """One-token recurrence. hidden: [B, 1, Dm]; cache = (conv_ring
    [B, K-1, di + 2n], state [B, H, P, N]). Returns (out [B, 1, Dm],
    (new_ring, new_state)), new tensors."""
    conv_ring, state = cache
    bsz = hidden.shape[0]
    di, n = dims.d_inner, dims.d_state
    h0 = hidden[:, 0]
    z = h0 @ params["w_z"]
    x_raw = h0 @ params["w_x"]
    bc_raw = h0 @ params["w_bc"]
    dt = (h0 @ params["w_dt"]).to(torch.float32) + params["dt_bias"]

    window = torch.cat([conv_ring, torch.cat([x_raw, bc_raw], -1)[:, None, :]], dim=1)
    conv_w = torch.cat([params["conv_x"], params["conv_bc"]], dim=-1)
    conv_b = torch.cat([params["conv_b_x"], params["conv_b_bc"]], dim=-1)
    conv_out = torch.einsum("bkc,kc->bc", window.to(torch.float32), conv_w.to(torch.float32))
    conv_out = F.silu(conv_out + conv_b.to(torch.float32)).to(hidden.dtype)
    new_ring = window[:, 1:]

    x = conv_out[..., :di].reshape(bsz, dims.n_heads, dims.head_dim)
    b_vec = conv_out[..., di:di + n].to(torch.float32)
    c_vec = conv_out[..., di + n:].to(torch.float32)

    dtf = _softplus(dt)                                        # [B, H]
    a = -torch.exp(params["A_log"].to(torch.float32))
    decay = torch.exp(dtf * a[None, :])                        # [B, H]
    upd = torch.einsum("bhp,bn->bhpn", x.to(torch.float32) * dtf[..., None], b_vec)
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, c_vec)
    y = y + params["D"].to(torch.float32)[None, :, None] * x.to(torch.float32)
    y = y.reshape(bsz, di).to(hidden.dtype)
    y = rms_norm(y * F.silu(z.to(torch.float32)).to(y.dtype), params["norm"])
    out = (y @ params["w_out"])[:, None, :]
    return out, (new_ring, state)
