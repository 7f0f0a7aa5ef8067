"""§6.1: Rosenbrock minimization with 100 heterogeneous workers (Figs. 1-2),
the port of ``repro.fl.rosenbrock``.

Heterogeneity: worker m sees v_m * F(.) with sum(v_m) = 1 and 80 of 100 v_m
negative (Eq. 11): 80 workers' gradient signs oppose the true gradient, the
regime where deterministic signSGD provably diverges and sparsign's
magnitude-awareness saves the vote. The standard Rosenbrock form is used (the
paper's Eq. 10 drops the square on the first term; see the JAX module).

Every worker's message goes through the compressor registry in one batched
call (``engine.compress_leaf`` with one seed per worker), so on the card one
kernel launch ternarizes a round. Worker selection comes from a
``torch.Generator``, not ``jax.random``: runs are deterministic, but select
other workers than the JAX module; the paper's claims are what carry over.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine, prng
from repro_torch.core.algorithm import CompressionConfig
from repro_torch.core.budgets import BudgetConfig

SELECT_SALT = 0x50B   # the torch.Generator stream of the per-round worker draws


def rosenbrock(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def make_heterogeneity(m: int = 100, n_neg: int = 80, seed: int = 0,
                       neg_mass: float = 0.8) -> np.ndarray:
    """v with sum 1 and n_neg negative entries (Eq. 11), the JAX module's
    construction: 80 workers carry negative scales of small total magnitude
    (neg_mass), the 20 positive ones carry 1 + neg_mass, so a majority by
    heads is wrong with probability near 1 while a magnitude-weighted vote
    recovers the true sign."""
    rng = np.random.RandomState(seed)
    neg = rng.uniform(0.5, 1.5, size=n_neg)
    neg *= neg_mass / neg.sum()
    pos = rng.uniform(0.5, 1.5, size=m - n_neg)
    pos *= (1.0 + neg_mass) / pos.sum()
    v = np.concatenate([-neg, pos])
    rng.shuffle(v)
    return v


@dataclasses.dataclass
class RosenbrockResult:
    values: np.ndarray          # F(x_t)
    wrong_agg: np.ndarray       # per-round share of wrongly aggregated coordinates
    x_final: np.ndarray


def run(
    compressor: str = "sparsign",
    budget: float = 0.01,
    *,
    m: int = 100,
    n_sel: int = 10,
    rounds: int = 300,
    d: int = 10,
    lr: float = 2e-4,
    seed: int = 0,
    device=None,
) -> RosenbrockResult:
    """signSGD ('sign') against SPARSIGNSGD ('sparsign') under Eq. 11
    heterogeneity; any ternary registry row votes. Runs on the card unless the
    caller passes ``device='cpu'``."""
    dev = resolve_device(device)
    comp = CompressionConfig(compressor=compressor, budget=BudgetConfig(value=budget))
    v_scales = torch.as_tensor(make_heterogeneity(m, seed=seed), dtype=torch.float32,
                               device=dev)
    x = torch.full((d,), -0.5, dtype=torch.float32, device=dev)
    widx = torch.arange(m, dtype=torch.int64)
    base = (prng.fold_seed_int(seed, 7) + widx * prng.GOLDEN) & prng.MASK32
    values, wrongs = [], []
    for r in range(rounds):
        g_true = torch.func.grad(rosenbrock)(x)
        g_workers = v_scales[:, None] * g_true[None, :]          # (M, d)
        gen = torch.Generator().manual_seed(prng.fold_seed_int(seed, SELECT_SALT, r))
        mask = torch.zeros(m, dtype=torch.bool)
        mask[torch.randperm(m, generator=gen)[:n_sel]] = True
        seeds = ((base + r * 0x85EBCA6B) & prng.MASK32).to(dev)
        votes = engine.compress_leaf(g_workers, comp, seeds).values
        votes = torch.where(mask.to(dev)[:, None], votes, torch.zeros((), dtype=torch.int8,
                                                                       device=dev))
        agg = torch.sign(votes.sum(dim=0, dtype=torch.int32))
        wrongs.append(torch.mean((agg != torch.sign(g_true)).to(torch.float32)))
        x = x - lr * agg.to(x.dtype)
        values.append(rosenbrock(x))
    return RosenbrockResult(values=torch.stack(values).cpu().numpy(),
                            wrong_agg=torch.stack(wrongs).cpu().numpy(),
                            x_final=x.cpu().numpy())
