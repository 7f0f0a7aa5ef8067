"""Mixture-of-Experts FFN, the port of ``repro.models.moe``: top-k routing
with shared experts.

Two implementations with the same semantics (equal when capacity drops
nothing):

  dense  — every expert runs on every token, gated combine; the oracle, for
           smoke-size configs.
  gather — the production path: each expert takes its top-C tokens by gate
           (C = ``capacity``), gathers them, runs its SwiGLU as a batched
           product over the experts, and the outputs are summed back per
           token. Tokens past capacity are dropped (GShard semantics).

Padded experts (``n_experts_padded > n_experts``) get router logits of
-1e30, so the router never selects them.

Selections follow ``jax.lax.top_k``: a stable descending sort, so equal
values go to the lower index. The combine (JAX's ``y.at[sel_tok].add``)
sums each token's contributions in ascending expert order into float32
zeros, one expert at a time with no repeated index inside a write, so no
float atomics run: a step gives the same bits on every run on the card. The
gather's backward is that same sum, and the combine's backward a gather.

``record_routes()`` notes each routed FFN's choices (the top-k experts a
token, the tokens an expert takes) inside its block; ``route_flips`` counts
where two runs' choices part.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.models.common import swiglu


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int            # real (unpadded) routed experts
    n_experts_padded: int     # >= n_experts
    top_k: int
    d_model: int
    d_ff: int                 # per-expert hidden
    capacity_factor: float = 1.25
    router_act: str = "softmax"   # softmax | sigmoid
    renorm_topk: bool = False


def capacity(dims: MoEDims, n_tokens: int) -> int:
    """Tokens an expert takes: cf * T * k / E truncated, at least 1, rounded
    up to a multiple of 8 and capped at T."""
    c = max(1, int(dims.capacity_factor * n_tokens * dims.top_k / dims.n_experts))
    return min(-(-c // 8) * 8, n_tokens)


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: (values, indices), ties to the
    lower index. The values are gathered from ``x``, so gradients flow."""
    idx = torch.sort(x.detach(), dim=-1, descending=True, stable=True).indices[..., :k]
    return x.gather(-1, idx), idx


def router_probs(x: torch.Tensor, w_router: torch.Tensor, dims: MoEDims) -> torch.Tensor:
    """[T, E_padded] float32 routing probabilities; padded experts masked."""
    logits = x.to(torch.float32) @ w_router.to(torch.float32)
    if dims.n_experts_padded > dims.n_experts:
        pad = torch.arange(dims.n_experts_padded, device=x.device) >= dims.n_experts
        logits = torch.where(pad[None, :], torch.full((), -1e30, device=x.device), logits)
    if dims.router_act == "softmax":
        return torch.softmax(logits, dim=-1)
    return torch.sigmoid(logits)


def _topk_gates(probs: torch.Tensor, dims: MoEDims):
    gate_vals, expert_idx = top_k(probs, dims.top_k)   # [T, k]
    if dims.renorm_topk:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return gate_vals, expert_idx


_ROUTES: list = []   # the open record_routes blocks' logs, innermost last


@contextlib.contextmanager
def record_routes():
    """Inside the block every routed FFN appends its choices to the yielded
    list, in call order: ("experts", [T, k] expert indices) at the top-k
    gates, ("tokens", [E, C] token indices) at the gather's capacity
    selection. A remat'ed block records again when its backward recomputes
    it: record a forward under ``torch.no_grad``."""
    log: list = []
    _ROUTES.append(log)
    try:
        yield log
    finally:
        _ROUTES.pop()


def _record(kind: str, idx: torch.Tensor) -> None:
    for log in _ROUTES:
        log.append((kind, idx.detach().clone()))


def route_flips(a: list, b: list) -> dict:
    """Where two ``record_routes`` logs of the same model and batch part:
    ``tokens``, the (layer, token) pairs whose top-k expert set differs;
    ``selections``, the (layer, expert) pairs whose capacity selection takes
    another set of tokens."""
    if [k for k, _ in a] != [k for k, _ in b]:
        raise ValueError("the two logs record different routed FFNs")
    out = {"tokens": 0, "selections": 0}
    for (kind, x), (_, y) in zip(a, b):
        key = "tokens" if kind == "experts" else "selections"
        differ = x.sort(-1).values.cpu() != y.sort(-1).values.cpu()
        out[key] += int(differ.any(-1).sum())
    return out


def _gate_matrix(probs: torch.Tensor, dims: MoEDims) -> torch.Tensor:
    """[T, E_padded] float32: each token's top-k gates, 0 where not routed."""
    gate_vals, expert_idx = _topk_gates(probs, dims)
    _record("experts", expert_idx)
    return torch.zeros_like(probs).scatter(1, expert_idx, gate_vals)


def capacity_select(assign: torch.Tensor, dims: MoEDims):
    """assign [T, E_padded] gates -> (sel_gate, sel_tok) [E, C]: each
    expert's top-C tokens by gate, C = ``capacity``."""
    sel_gate, sel_tok = top_k(assign.T, capacity(dims, assign.shape[0]))
    _record("tokens", sel_tok)
    return sel_gate, sel_tok


def _sum_per_token(rows: torch.Tensor, sel: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """rows [E, C, D], sel [E, C] token indices (distinct within an expert) ->
    [T, D] float32: row (e, c) added into token sel[e, c], expert after
    expert from float32 zeros."""
    y = torch.zeros((n_tokens, rows.shape[-1]), dtype=torch.float32, device=rows.device)
    for e in range(rows.shape[0]):
        idx = sel[e]
        y.index_copy_(0, idx, y.index_select(0, idx) + rows[e].to(torch.float32))
    return y


class _Dispatch(torch.autograd.Function):
    """x [T, D] -> x[sel] [E, C, D]; the backward sums each token's rows."""

    @staticmethod
    def forward(ctx, x, sel):
        ctx.save_for_backward(sel)
        ctx.n_tokens = x.shape[0]
        return x.index_select(0, sel.reshape(-1)).view(sel.shape + x.shape[1:])

    @staticmethod
    def backward(ctx, g):
        (sel,) = ctx.saved_tensors
        return _sum_per_token(g, sel, ctx.n_tokens).to(g.dtype), None


class _Combine(torch.autograd.Function):
    """rows [E, C, D] -> [T, D] float32 per-token sums; the backward gathers."""

    @staticmethod
    def forward(ctx, rows, sel, n_tokens):
        ctx.save_for_backward(sel)
        return _sum_per_token(rows, sel, n_tokens)

    @staticmethod
    def backward(ctx, g):
        (sel,) = ctx.saved_tensors
        return g.index_select(0, sel.reshape(-1)).view(sel.shape + g.shape[1:]), None, None


def _expert_ffn(xin: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """xin [E, C, Dm]; weights [E, Dm, F] and [E, F, Dm]: the ``ecd,edf->ecf``
    products as batched matmuls."""
    h = swiglu(torch.bmm(xin, w_gate), torch.bmm(xin, w_up))
    return torch.bmm(h, w_down)


def route(x: torch.Tensor, w_router: torch.Tensor, dims: MoEDims) -> torch.Tensor:
    """x [T, Dm] -> [T, E_padded] float32: each token's top-k gates, 0 where
    not routed."""
    return _gate_matrix(router_probs(x, w_router, dims), dims)


def routed_partial(params: dict, x: torch.Tensor, sel_gate: torch.Tensor,
                   sel_tok: torch.Tensor) -> torch.Tensor:
    """The gather's experts on their capacity selections: ``params``'
    ``w_gate``/``w_up``/``w_down`` hold E' experts and ``sel_gate``/``sel_tok``
    their rows [E', C]; x [T, Dm] -> [T, Dm] float32, the combine of those
    experts' outputs (all experts, or a range of them: expert parallelism
    sums the ranges' partials)."""
    xin = _Dispatch.apply(x, sel_tok)
    out = _expert_ffn(xin.to(x.dtype), params["w_gate"], params["w_up"], params["w_down"])
    out = out * (sel_gate * (sel_gate > 0.0))[..., None].to(out.dtype)
    return _Combine.apply(out.to(torch.float32), sel_tok, x.shape[0])


def moe_ffn_gather(params: dict, x: torch.Tensor, dims: MoEDims) -> torch.Tensor:
    """x [T, Dm] -> [T, Dm]."""
    sel_gate, sel_tok = capacity_select(route(x, params["router"], dims), dims)   # [E, C]
    return routed_partial(params, x, sel_gate, sel_tok).to(x.dtype)


def dense_partial(params: dict, x: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """The oracle's experts on every token: ``params``' E' experts and their
    columns of the gates [T, E'] -> [T, Dm] float32."""
    outs = swiglu(torch.matmul(x, params["w_gate"]), torch.matmul(x, params["w_up"]))
    outs = torch.matmul(outs, params["w_down"])     # [E', T, Dm]
    return torch.einsum("te,etd->td", gates, outs.to(torch.float32))


def moe_ffn_dense(params: dict, x: torch.Tensor, dims: MoEDims) -> torch.Tensor:
    """The oracle: every expert on every token, top-k gates, no drops."""
    return dense_partial(params, x, route(x, params["router"], dims)).to(x.dtype)


def shared_expert(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The always-on shared expert's SwiGLU (``shared_*``, whole or a column
    slice of its hidden width)."""
    return swiglu(x @ params["shared_w_gate"], x @ params["shared_w_up"]) @ \
        params["shared_w_down"]


def moe_ffn(params: dict, x: torch.Tensor, dims: MoEDims, impl: str = "gather") -> torch.Tensor:
    """Routed experts plus the always-on shared expert (``params['shared_*']``)."""
    fn = moe_ffn_gather if impl == "gather" else moe_ffn_dense
    y = fn(params, x, dims)
    if "shared_w_gate" in params:
        y = y + shared_expert(params, x)
    return y


#: each leaf's logical axes, as JAX's ``blocks.block_param_defs`` names them
MOE_LOGICAL_AXES = {
    "router": (None, None),
    "w_gate": ("expert", None, None), "w_up": ("expert", None, None),
    "w_down": ("expert", None, None),
    "shared_w_gate": (None, "ff"), "shared_w_up": (None, "ff"), "shared_w_down": ("ff", None),
}


def moe_param_shapes(dims: MoEDims, n_shared: int, dtype: torch.dtype) -> dict:
    """name -> (shape, dtype); the router is float32 whatever ``dtype``."""
    e, dm, f = dims.n_experts_padded, dims.d_model, dims.d_ff
    shapes = {
        "router": ((dm, e), torch.float32),
        "w_gate": ((e, dm, f), dtype),
        "w_up": ((e, dm, f), dtype),
        "w_down": ((e, f, dm), dtype),
    }
    if n_shared > 0:
        fs = n_shared * f
        shapes.update({
            "shared_w_gate": ((dm, fs), dtype),
            "shared_w_up": ((dm, fs), dtype),
            "shared_w_down": ((fs, dm), dtype),
        })
    return shapes
