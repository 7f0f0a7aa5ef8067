"""Compression-budget (B) policies, the port of ``repro.core.budgets``.

  fixed:           B constant (the paper's experimental choice).
  linf_share:      B = 1 / max_m ||g_m||_inf (TernGrad-style magnitude sharing).
  l2_norm:         B = sqrt(d) / ||g||_2 * value.
  target_sparsity: B with mean(min(|g| B, 1)) == value, by geometric bisection.

Budgets stay on the device as float32 tensors (the sparsign kernel reads B
from device memory), so no policy needs a host round trip. ``rows=True``
treats g as (workers, ...) and returns one budget per row.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.common import device_tensor


BUDGET_KINDS = ("fixed", "linf_share", "l2_norm", "target_sparsity")


@dataclasses.dataclass(frozen=True)
class BudgetConfig:
    kind: str = "fixed"          # fixed | linf_share | l2_norm | target_sparsity
    value: float = 1.0           # B for fixed; target nnz fraction for target_sparsity
    local_value: Optional[float] = None  # B_l for local steps (EF-SPARSIGNSGD)


def _flat(g: torch.Tensor, rows: bool) -> torch.Tensor:
    gf = g.to(torch.float32)
    return gf.reshape(gf.shape[0], -1) if rows else gf.reshape(1, -1)


def expected_sparsity(g: torch.Tensor, budget) -> torch.Tensor:
    """E[nnz]/d = mean(clip(|g| * B, 0, 1)) (Def. 1)."""
    return torch.mean(torch.clamp(torch.abs(g.to(torch.float32)) * device_tensor(budget, g), 0.0, 1.0))


def solve_budget_for_sparsity(g: torch.Tensor, target: float, iters: int = 30, *,
                              rows: bool = False) -> torch.Tensor:
    """Bisection for B with mean(clip(|g|B, 0, 1)) == target, halving log B
    (mid = sqrt(lo) * sqrt(hi)) so 30 steps resolve the ~32-decade bracket."""
    absg = torch.abs(_flat(g, rows))
    inf = device_tensor(float("inf"), absg)
    min_nz = torch.amin(torch.where(absg > 0, absg, inf), dim=1)
    hi = 1.0 / torch.clamp(min_nz, min=1e-20)
    hi = torch.clamp(hi, max=1e20)
    lo = torch.clamp(hi, max=1e-12)
    for _ in range(iters):
        mid = torch.sqrt(lo) * torch.sqrt(hi)
        s = torch.mean(torch.clamp(absg * mid[:, None], 0.0, 1.0), dim=1)
        below = s < target
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    out = torch.sqrt(lo) * torch.sqrt(hi)
    return out if rows else out[0]


def solve_budget_for_sparsity_slices(parts, target: float, numel: int, *, psum, pmax,
                                     iters: int = 30) -> torch.Tensor:
    """``solve_budget_for_sparsity`` of a leaf cut into model ranks' slices:
    ``parts`` holds this process's slices, ``psum`` and ``pmax`` reduce one
    partial a local rank over 'model' (``collectives.tp_sum``, the ordered
    all-reduce, and ``tp_max``). The smallest nonzero is exact (the max of
    the slices' negated minima); each iteration's mean over the whole leaf
    is one ordered sum of the slices' partial sums over ``numel``, so every
    rank sees the same bits, takes the same branch and ends on one B, which
    is asserted (a device-side check, no host read)."""
    absg = [torch.abs(x.to(torch.float32)).reshape(-1) for x in parts]
    inf = device_tensor(float("inf"), absg[0])
    min_nz = -pmax([-torch.amin(torch.where(a > 0, a, inf)) for a in absg])
    hi = 1.0 / torch.clamp(min_nz, min=1e-20)
    hi = torch.clamp(hi, max=1e20)
    lo = torch.clamp(hi, max=1e-12)
    n = device_tensor(float(numel), absg[0])
    for _ in range(iters):
        mid = torch.sqrt(lo) * torch.sqrt(hi)
        s = psum([torch.sum(torch.clamp(a * mid, 0.0, 1.0)) for a in absg]) / n
        below = s < target
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    out = torch.sqrt(lo) * torch.sqrt(hi)
    every = [out] * len(parts)
    torch._assert_async(pmax(every) == -pmax([-b for b in every]),
                        "the model ranks of a worker ended the bisection on different budgets")
    return out


def resolve_budget(cfg: BudgetConfig, g: torch.Tensor, *, shared_linf=None,
                   rows: bool = False, leaf_slice=None) -> torch.Tensor:
    """The float32 B to feed sparsign for ``g``: 0-d, or (rows,) with ``rows``.
    ``leaf_slice`` (``engine.LeafSlice``): g is a model rank's slice, and the
    L2 budget reads the whole leaf's size and sum of squares (reduced over
    'model' in rank order) instead of g's own, ``target_sparsity`` the budget
    solved on the whole leaf (``solve_budget_for_sparsity_slices``)."""
    shape = (g.shape[0],) if rows else ()
    if cfg.kind == "fixed":
        return torch.full(shape, cfg.value, dtype=torch.float32, device=g.device)
    if cfg.kind == "linf_share":
        if shared_linf is not None:
            s = device_tensor(shared_linf, g).expand(shape)
        else:
            s = torch.amax(torch.abs(_flat(g, rows)), dim=1).reshape(shape)
        return 1.0 / torch.clamp(s, min=1e-12)
    if cfg.kind == "l2_norm" and leaf_slice is not None:
        d = device_tensor(float(leaf_slice.numel), g)
        n = torch.sqrt(leaf_slice.sum_sq)
        return torch.sqrt(d) / torch.clamp(n, min=1e-12) * device_tensor(cfg.value, g)
    if cfg.kind == "l2_norm":
        # upcast inside the reduction: on the card no float32 copy of a bf16
        # leaf is made (12.9 GB for one of jamba's 3.2 B-coordinate leaves)
        flat = g.reshape(g.shape[0], -1) if rows else g.reshape(1, -1)
        n = torch.linalg.vector_norm(flat, dim=1, dtype=torch.float32).reshape(shape)
        d = device_tensor(float(flat.shape[1]), g)
        return torch.sqrt(d) / torch.clamp(n, min=1e-12) * device_tensor(cfg.value, g)
    if cfg.kind == "target_sparsity" and leaf_slice is not None:
        if leaf_slice.budget is None:
            raise ValueError("a model rank's slice takes the target_sparsity budget solved on "
                             "the whole leaf (engine.leaf_slices)")
        return leaf_slice.budget
    if cfg.kind == "target_sparsity":
        return solve_budget_for_sparsity(g, cfg.value, rows=rows)
    raise ValueError(f"unknown budget kind {cfg.kind!r}; known: {BUDGET_KINDS}")
