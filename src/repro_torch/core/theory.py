"""Executable versions of the paper's theory (Thm. 1, Cor. 1, Thm. 2's kappa),
the port of ``repro.core.theory``: the closed forms in float32, as the JAX
package computes them without x64, and a Monte Carlo of the wrong-aggregation
event on a ``torch.Generator``. Tests hold the Monte Carlo under the Thm. 1
bound; ``fl.rosenbrock`` reproduces the curves of Figs. 1-2."""

from __future__ import annotations

from typing import Optional

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _int_pow(x: torch.Tensor, m: int) -> torch.Tensor:
    """x ** m for an int m >= 1 by binary exponentiation, the float32 products
    JAX's ``x ** m`` (``lax.integer_pow``) takes; ``torch.pow`` rounds once
    and differs in the last bits."""
    acc = None
    while m > 0:
        if m & 1:
            acc = x if acc is None else acc * x
        m >>= 1
        if m > 0:
            x = x * x
    return acc


def wrong_aggregation_bound(p_bar, q_bar, m: int) -> torch.Tensor:
    """Theorem 1: P(wrong vote) <= [1 - (sqrt(q_bar) - sqrt(p_bar))^2]^M,
    valid when q_bar > p_bar."""
    base = 1.0 - _int_pow(torch.sqrt(_f32(q_bar)) - torch.sqrt(_f32(p_bar)), 2)
    return _int_pow(base, int(m))


def sparsign_pq(u: torch.Tensor, budget, p_select=1.0):
    """Corollary 1: (p_bar, q_bar) for sparsign on fixed worker scalars u_m.
    Workers whose sign disagrees with sign(mean u) make p_bar, those that
    agree q_bar; each transmits with probability clip(|u_m| B, 0, 1) * p_s."""
    u = u.to(torch.float32)
    s = torch.sign(torch.mean(u))
    keep = torch.clamp(torch.abs(u) * _f32(budget), 0.0, 1.0) * _f32(p_select)
    agree = torch.sign(u) == s
    nonzero = torch.sign(u) != 0
    zero = torch.zeros((), dtype=torch.float32)
    q_bar = torch.mean(torch.where(agree & nonzero, keep, zero))
    p_bar = torch.mean(torch.where(~agree & nonzero, keep, zero))
    return p_bar, q_bar


def deterministic_sign_pq(u: torch.Tensor, p_select=1.0):
    """(p_bar, q_bar) for signSGD: every selected worker sends its sign."""
    u = u.to(torch.float32)
    s = torch.sign(torch.mean(u))
    agree = (torch.sign(u) == s) & (torch.sign(u) != 0)
    disagree = (torch.sign(u) != s) & (torch.sign(u) != 0)
    ps, zero = _f32(p_select), torch.zeros((), dtype=torch.float32)
    return (torch.mean(torch.where(disagree, ps, zero)),
            torch.mean(torch.where(agree, ps, zero)))


def monte_carlo_wrong_aggregation(generator: torch.Generator, u: torch.Tensor, budget,
                                  n_trials: int = 4096, p_select: float = 1.0,
                                  n_sampled: Optional[int] = None) -> torch.Tensor:
    """Empirical P(sign(sum of sparsign votes) != sign(mean u)), all trials at
    once. Workers are sampled n_sampled without replacement, or each with
    probability p_select. Ties (vote sum 0) count as wrong, the X_m >= 0 event
    of the Thm. 1 proof."""
    u = u.to(torch.float32)
    m = u.shape[0]
    s = torch.sign(torch.mean(u))
    if n_sampled is not None:
        order = torch.argsort(torch.rand((n_trials, m), generator=generator), dim=1)
        mask = order < n_sampled   # a uniformly random n_sampled-subset per trial
    else:
        mask = torch.rand((n_trials, m), generator=generator) < p_select
    keep = (torch.rand((n_trials, m), generator=generator)
            < torch.clamp(torch.abs(u) * _f32(budget), 0.0, 1.0))
    votes = torch.where(mask & keep, torch.sign(u), torch.zeros((), dtype=torch.float32))
    wrong = torch.sign(torch.sum(votes, dim=1)) != s
    return torch.mean(wrong.to(torch.float32))


def kappa(g_workers: torch.Tensor, budget, p_select=1.0) -> torch.Tensor:
    """Theorem 2's kappa for one coordinate given the per-worker gradients
    g_workers [M]; kappa < 1/2 is the convergence-enabling event."""
    g = g_workers.to(torch.float32)
    m = g.shape[0]
    mean_g = torch.mean(g)
    s = torch.sign(mean_g)
    agree = torch.sign(g) == s
    zero = torch.zeros((), dtype=torch.float32)
    sum_agree = torch.sum(torch.where(agree, torch.abs(g), zero)) / m
    sum_dis = torch.sum(torch.where(~agree, torch.abs(g), zero)) / m
    denom = _int_pow(torch.sqrt(sum_agree) + torch.sqrt(sum_dis), 2)
    ratio = torch.abs(mean_g) / torch.clamp(denom, min=1e-20)
    return _int_pow(1.0 - _f32(budget) * _f32(p_select) * ratio, m)
