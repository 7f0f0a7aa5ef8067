"""SPARSIGNSGD (Alg. 1) and EF-SPARSIGNSGD with local updates (Alg. 2), the
port of ``repro.core.algorithm``, split into the roles a round composes:

  worker_message      — worker-side compression (optionally after tau local steps)
  (vote aggregation)  — a sum over workers
  server_update       — C(.) + optional server-side error feedback

Seeds are uint32 with wrap-around. Host ints stay host ints (``*_int`` of
``core.prng``), so they reach the kernels as launch arguments; int64 tensors
of seeds give tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import engine, prng
from repro_torch.core.aggregation import majority_vote, mean_server, scaled_sign_server
from repro_torch.core.budgets import BudgetConfig
from repro_torch.core.compressors import CompressedGrad, get_spec
from repro_torch.core.error_feedback import EFState, ef_server_step
from repro_torch.kernels.common import device_tensor

# Inner (Alg. 2) local steps accumulate ternary votes in int32: exact for any
# tau in this range (each step contributes {-1, 0, +1} per coordinate).
MAX_LOCAL_STEPS = 2**31 - 1

LOCAL_STEP_SALT = 1001   # inner sparsign stream, shared by the tau steps
UPLINK_SALT = 2          # the final Q(sum, B_g) uplink stream
WORKER_SALT = 0x5EED     # per-worker stream derivation


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Everything that defines the communication algorithm for one run."""

    compressor: str = "sparsign"
    budget: BudgetConfig = dataclasses.field(default_factory=BudgetConfig)
    server: str = "majority_vote"        # majority_vote | scaled_sign_ef | mean
    local_steps: int = 1                 # tau (Alg. 2); 1 recovers Alg. 1
    local_budget: Optional[float] = None # B_l for the inner compressed steps
    worker_sample_fraction: float = 1.0  # p_s: the trainer's per-round worker sampling

    def __post_init__(self):
        tau = int(self.local_steps)
        if not 1 <= tau <= MAX_LOCAL_STEPS:
            raise ValueError(
                f"local_steps (tau) must be in [1, {MAX_LOCAL_STEPS}]: the int32 "
                f"local-vote accumulator is exact only in that range; got "
                f"{self.local_steps}")

    @property
    def is_ternary(self) -> bool:
        return get_spec(self.compressor).is_ternary


def fold(seed, *salts):
    """``fold_seed`` on a host int (host result) or a tensor of seeds."""
    if isinstance(seed, torch.Tensor):
        return prng.fold_seed(seed, *salts)
    return prng.fold_seed_int(seed, *salts)


def worker_message(g_local, cfg: CompressionConfig, *, seed, counter_base=0,
                   shared_linf=None, backend=None) -> CompressedGrad:
    """Q(g_m, B_m): one worker's uplink message (or all rows' at once)."""
    return engine.compress_leaf(g_local, cfg, seed, counter_base,
                                shared_linf=shared_linf, backend=backend)


def local_update_source(
    w0: torch.Tensor,
    grad_fn: Callable,   # (w, c) -> local stochastic gradient at local step c
    cfg: CompressionConfig,
    *,
    eta_l: float,
    seed,
    counter_base=0,
    backend=None,
) -> torch.Tensor:
    """Alg. 2 inner loop: tau compressed local steps; returns the float32 sum
    of the local compressed gradients (the uplink's input). With a 1-D
    ``seed`` of per-worker seeds, w0 is (workers, ...) and every worker steps
    at once. The JAX ``lax.scan`` is a Python loop with an int32 accumulator."""
    tau = int(cfg.local_steps)
    local_cfg = engine.local_step_config(cfg)
    inner_seed = fold(seed, LOCAL_STEP_SALT)
    per_row = w0[0].numel() if engine.is_batched(seed) else w0.numel()
    w = w0
    acc = torch.zeros(w0.shape, dtype=torch.int32, device=w0.device)
    eta = device_tensor(float(eta_l), w0, w0.dtype)
    for c in range(tau):
        g = grad_fn(w, c)
        q = engine.compress_leaf(g, local_cfg, inner_seed,
                                 counter_base=(int(counter_base) + c * per_row) & prng.MASK32,
                                 backend=backend)
        w = w - eta * q.values.to(w.dtype)
        acc += q.values.to(torch.int32)
    return acc.to(torch.float32)


def local_update_message(w0, grad_fn, cfg: CompressionConfig, *, eta_l, seed,
                         counter_base=0, shared_linf=None, backend=None) -> CompressedGrad:
    """Alg. 2 worker loop: ``local_update_source`` then Q(sum, B_g)."""
    src = local_update_source(w0, grad_fn, cfg, eta_l=eta_l, seed=seed,
                              counter_base=counter_base, backend=backend)
    return worker_message(src, cfg, seed=fold(seed, UPLINK_SALT), counter_base=counter_base,
                          shared_linf=shared_linf, backend=backend)


def server_update(vote_mean: torch.Tensor, cfg: CompressionConfig,
                  ef_state: Optional[EFState] = None):
    """C(mean of worker messages) [+ EF]: (g_tilde float32, new EF state)."""
    if cfg.server == "majority_vote":
        return majority_vote(vote_mean).to(torch.float32), ef_state
    if cfg.server == "mean":
        return mean_server(vote_mean), ef_state
    if cfg.server == "scaled_sign_ef":
        if ef_state is None:
            raise ValueError("scaled_sign_ef requires an EFState")
        return ef_server_step(ef_state, vote_mean, scaled_sign_server)
    raise ValueError(f"unknown server rule {cfg.server!r}")


def reference_round(
    w: torch.Tensor,
    per_worker_grads: torch.Tensor,   # [M, *w.shape]
    cfg: CompressionConfig,
    *,
    eta: float,
    seed: int,
    ef_state: Optional[EFState] = None,
    participation_mask: Optional[torch.Tensor] = None,  # [M] bool
):
    """One full Alg. 1 round on explicit per-worker gradients."""
    m = per_worker_grads.shape[0]
    mask = (participation_mask if participation_mask is not None
            else torch.ones(m, dtype=torch.bool, device=w.device))
    seeds = worker_stream_seed(seed, torch.arange(m, dtype=torch.int64))
    msg = worker_message(per_worker_grads, cfg, seed=seeds, counter_base=0)
    decoded = msg.values.to(torch.float32) * msg.scale
    decoded = torch.where(mask.reshape((m,) + (1,) * (decoded.dim() - 1)), decoded,
                          torch.zeros((), dtype=torch.float32, device=w.device))
    n_sel = torch.clamp(torch.sum(mask), min=1)
    vote_mean = torch.sum(decoded, dim=0) / n_sel
    g_tilde, ef_state = server_update(vote_mean, cfg, ef_state)
    return w - eta * g_tilde.to(w.dtype), ef_state


def _worker_seed(seed, widx):
    """Independent stream per worker: fold(seed, 0x5EED) + widx * 0x9E3779B9
    (mod 2^32). Host ints give an int, a tensor of indices a tensor."""
    base = fold(seed, WORKER_SALT)
    if isinstance(widx, torch.Tensor):
        return (torch.as_tensor(base, dtype=torch.int64)
                + (widx.to(torch.int64) & prng.MASK32) * prng.GOLDEN) & prng.MASK32
    return (int(base) + int(widx) * prng.GOLDEN) & prng.MASK32


def worker_stream_seed(seed, widx):
    """Public alias: the per-worker sparsign stream seed."""
    return _worker_seed(seed, widx)
