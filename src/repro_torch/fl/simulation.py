"""M-worker federated simulation of Algorithms 1 & 2 — the paper's §6 engine,
ported from ``repro.fl.simulation``. One round on flat parameter vectors:

  select |S| workers -> each runs tau compressed local steps (Alg. 2) or one
  gradient (Alg. 1) -> uplink Q(., B_g) -> server C(.) [+ EF] -> update.

A round is two halves. The worker half samples the workers and computes
their uplink inputs (the sources) and stream seeds; the server half
compresses every source with its seed in one batched kernel launch, sums the
decoded messages and applies the server rule. The halves are public, so a
test can hand the same sources to this package and to the JAX package.

Elastic participation (``worker_weights``, ``q_frac``, ``dropout``) makes the
server half a weighted vote over the workers whose reports arrive (a
counter-hash report mask, bit for bit the JAX package's), normalized to the
realized participation W: a majority vote steps where ``|sum w_m msg_m| >=
q_frac * W`` (the ``weighted_vote_update`` kernel), a mean divides by W.

Workers are a batch dimension (``torch.func.vmap`` of ``torch.func.grad``)
where JAX has ``jax.vmap``. Worker selection and batch indices come from a
``torch.Generator`` seeded per round from ``cfg.seed``: deterministic, but not
``jax.random``'s numbers. The compression seeds are the JAX package's, bit for
bit: fold_seed(seed, 0x5EED) + widx * 0x9E3779B9 + round * 0x85EBCA6B (mod 2^32).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine, prng
from repro_torch.core.algorithm import (UPLINK_SALT, CompressionConfig, fold,
                                        local_update_source, worker_stream_seed)
from repro_torch.core.encoding import baseline_bits_per_round
from repro_torch.dist.collectives import ParticipationSpec
from repro_torch.fl.models import accuracy, xent_loss
from repro_torch.kernels.common import jnp_sign
from repro_torch.train.sampling import report_mask

ROUND_SEED_MUL = 0x85EBCA6B
SAMPLE_SALT = 0x5A3B1E   # the torch.Generator stream of worker and batch draws


@dataclasses.dataclass
class FLConfig:
    n_workers: int = 100
    participation: float = 1.0      # fraction sampled per round
    rounds: int = 200
    batch_size: int = 128
    lr: float = 0.01                # eta: the server step size
    local_lr: float = 0.01          # eta_L: the inner local step size (Alg. 2 only)
    comp: CompressionConfig = dataclasses.field(default_factory=CompressionConfig)
    seed: int = 0
    eval_every: int = 10
    quorum: int = 1                 # vote-server deadband (majority_vote only)
    # elastic participation (any set -> weighted, participation-normalized
    # aggregation): per-global-worker vote weights (len n_workers), the quorum
    # as a fraction of realized participation W, and a per-round report
    # dropout on top of sampling. None / 0.0 everywhere is the fixed-count round.
    worker_weights: Optional[tuple] = None
    q_frac: Optional[float] = None
    dropout: float = 0.0


class RoundFn:
    """One federated round, ``(v, ef, round_idx) -> (v, ef, mean nnz)``,
    with its worker and server halves callable on their own."""

    def __init__(self, loss_fn: Callable, cfg: FLConfig, x_parts, y_parts, device,
                 backend: Optional[str]):
        self.cfg = cfg
        self.comp = cfg.comp
        self.device = device
        self.backend = backend
        self.server_rule = self.comp.server if engine.is_vote_server(self.comp) else "mean"
        self.share_linf = engine.needs_shared_linf(self.comp)
        self.n_sel = max(1, int(round(cfg.participation * cfg.n_workers)))
        self.part = None
        if (cfg.worker_weights is not None or cfg.q_frac is not None
                or cfg.dropout > 0.0):
            self.part = ParticipationSpec(weights=cfg.worker_weights, q_frac=cfg.q_frac,
                                          dropout=cfg.dropout)
            engine.check_participation_server(self.server_rule, self.comp.compressor)
            if self.part.weights is not None and len(self.part.weights) != cfg.n_workers:
                raise ValueError(
                    f"worker_weights cover {len(self.part.weights)} workers but the "
                    f"simulation has n_workers={cfg.n_workers} (weights are per global "
                    f"worker id, not per sampled slot)")
            # the quorum normalizes to whoever reports: a fraction of W
            self.q_frac = self.part.resolve_q_frac(cfg.quorum, self.n_sel)
            self.weights = self.part.weights_array(cfg.n_workers, device)
        self.x_parts = torch.as_tensor(x_parts, device=device)
        self.y_parts = torch.as_tensor(y_parts, device=device)
        self.grads = torch.func.vmap(torch.func.grad(loss_fn))

    def workers(self, v: torch.Tensor, round_idx: int):
        """Sample |S| workers and compute their uplink sources (|S|, d), uplink
        stream seeds and global worker ids (int64 tensors on the device)."""
        cfg, comp = self.cfg, self.comp
        gen = torch.Generator().manual_seed(prng.fold_seed_int(cfg.seed, SAMPLE_SALT, round_idx))
        sel = torch.randperm(cfg.n_workers, generator=gen)[:self.n_sel]
        steps = int(comp.local_steps)
        idx = torch.randint(0, self.x_parts.shape[1], (steps, self.n_sel, cfg.batch_size),
                            generator=gen).to(self.device)
        seeds = (worker_stream_seed(cfg.seed, sel) + round_idx * ROUND_SEED_MUL) & prng.MASK32
        seeds = seeds.to(self.device)
        sel = sel.to(self.device)

        def grad_at(w, step):
            xb = self.x_parts[sel[:, None], idx[step]]
            yb = self.y_parts[sel[:, None], idx[step]]
            return self.grads(w, xb, yb)

        w0 = v.expand(self.n_sel, -1)
        if steps == 1:
            return grad_at(w0, 0), seeds, sel
        src = local_update_source(w0, grad_at, comp, eta_l=cfg.local_lr, seed=seeds,
                                  backend=self.backend)
        return src, fold(seeds, UPLINK_SALT), sel

    def reporting(self, sel: torch.Tensor, round_idx: int):
        """Elastic rounds: (report mask, w_eff) of the sampled workers ``sel``;
        w_eff is the static weight times the report bit (an exact 0.0 for a
        worker whose report does not arrive)."""
        rmask = report_mask(self.cfg.seed, round_idx, sel, self.part.dropout)
        return rmask, self.weights[sel] * rmask.to(torch.float32)

    def _messages(self, srcs, seeds, rmask, backend):
        """Compress every source with its seed: (decoded messages, nnz per
        message). ``rmask`` (elastic rounds) keeps a lost report out of the
        magnitude-sharing max."""
        shared = None
        if self.share_linf:  # the magnitude-sharing max over the sampled set
            mags = torch.amax(torch.abs(srcs.to(torch.float32)), dim=1)
            if rmask is not None:  # over the reporters: a lost report shares nothing
                mags = torch.where(rmask, mags, torch.zeros((), device=mags.device))
            shared = torch.amax(mags)
        msg = engine.compress_leaf(srcs, self.comp, seeds, shared_linf=shared, backend=backend)
        dec = msg.values.to(torch.float32) * msg.scale
        return dec, torch.abs(jnp_sign(msg.values)).to(torch.float32).sum(dim=1)

    def weighted_vote(self, srcs, seeds, sel, round_idx: int, *,
                      backend: Optional[str] = None):
        """Elastic rounds: the weighted vote sum(dec * w_eff) of the sampled
        workers ``sel``, W = sum(w_eff), and the mean nnz per message with a
        lost report counted as 0."""
        backend = backend if backend is not None else self.backend
        rmask, w_eff = self.reporting(sel, round_idx)
        dec, nnz = self._messages(srcs, seeds, rmask, backend)
        return (torch.sum(dec * w_eff[:, None], dim=0), torch.sum(w_eff),
                torch.mean(nnz * rmask.to(torch.float32)))

    def server(self, v, ef, srcs, seeds, sel=None, round_idx: int = 0, *,
               backend: Optional[str] = None):
        """Compress every source with its seed, sum the decoded messages and
        apply the server rule. Returns (v, ef, mean nnz per message). An
        elastic round also needs the sampled workers' global ids ``sel`` and
        the round index, which pick the weights and the report mask."""
        backend = backend if backend is not None else self.backend
        if self.part is not None:
            if sel is None:
                raise ValueError("an elastic round's server half needs sel, the sampled "
                                 "workers' global ids")
            wv, wtot, nnz = self.weighted_vote(srcs, seeds, sel, round_idx, backend=backend)
            if self.server_rule == "majority_vote":
                v, ef = engine.server_apply(v, wv, self.comp, lr=self.cfg.lr, ef=ef,
                                            part_total=wtot, q_frac=self.q_frac,
                                            backend=backend)
            else:
                v, ef = engine.server_apply(v, wv, self.comp, lr=self.cfg.lr, ef=ef,
                                            n_sel=wtot, server="mean", backend=backend)
            return v, ef, nnz
        dec, nnz = self._messages(srcs, seeds, None, backend)
        v, ef = engine.server_apply(
            v, torch.sum(dec, dim=0), self.comp, lr=self.cfg.lr, ef=ef,
            n_sel=float(self.n_sel), server=self.server_rule, quorum=self.cfg.quorum,
            backend=backend)
        return v, ef, torch.mean(nnz)

    def __call__(self, v, ef, round_idx: int):
        srcs, seeds, sel = self.workers(v, round_idx)
        return self.server(v, ef, srcs, seeds, sel, round_idx)


def build_round_fn(loss_fn: Callable, cfg: FLConfig, x_parts, y_parts, *, device=None,
                   backend: Optional[str] = None) -> RoundFn:
    """x_parts: [M, shard, ...] stacked per-worker data (padded to equal shard).
    Runs on ``device`` (the card unless the caller passes ``device='cpu'``).
    Elastic fields are validated here, at build time."""
    return RoundFn(loss_fn, cfg, x_parts, y_parts, resolve_device(device), backend)


def run_fl(
    v0: torch.Tensor,
    apply_fn: Callable,
    cfg: FLConfig,
    x_parts: np.ndarray, y_parts: np.ndarray,
    x_test: np.ndarray, y_test: np.ndarray,
    *,
    log: Optional[Callable[[str], None]] = None,
    device=None,
    backend: Optional[str] = None,
) -> dict:
    """Returns {'acc': [(round, acc)], 'final_acc', 'mean_nnz',
    'uplink_bits_per_round', 'd', 'round_s', 'v'}; ``round_s`` holds each
    round's host seconds, which end in a device sync (the nnz read), and
    ``v`` the final weights."""
    dev = resolve_device(device)
    round_fn = build_round_fn(xent_loss(apply_fn), cfg, x_parts, y_parts, device=dev,
                              backend=backend)
    v = v0.to(dev, torch.float32)
    ef = torch.zeros_like(v)
    xt = torch.as_tensor(x_test, device=dev)
    yt = torch.as_tensor(y_test, device=dev)
    accs, nnzs, round_s = [], [], []
    for r in range(cfg.rounds):
        t0 = time.perf_counter()
        v, ef, nnz = round_fn(v, ef, r)
        nnzs.append(float(nnz))
        round_s.append(time.perf_counter() - t0)
        if (r + 1) % cfg.eval_every == 0 or r == cfg.rounds - 1:
            acc = accuracy(apply_fn, v, xt, yt)
            accs.append((r + 1, acc))
            if log:
                log(f"[fl] round {r + 1}: acc={acc:.4f} nnz={nnzs[-1]:.0f}")
    mean_nnz = float(np.mean(nnzs)) if nnzs else 0.0
    d = int(v0.numel())
    bits = baseline_bits_per_round(d, cfg.comp.compressor, nnz=mean_nnz)
    n_sel = max(1, int(round(cfg.participation * cfg.n_workers)))
    return {
        "acc": accs,
        "final_acc": accs[-1][1] if accs else float("nan"),
        "mean_nnz": mean_nnz,
        "uplink_bits_per_round": bits * n_sel,
        "d": d,
        "round_s": round_s,
        "v": v,
    }


def stack_partitions(x, y, parts) -> tuple[np.ndarray, np.ndarray]:
    """Per-worker shards stacked to [M, shard_max, ...] (wrap-padded)."""
    shard = max(len(p) for p in parts)
    xs, ys = [], []
    for idx in parts:
        reps = np.resize(idx, shard)
        xs.append(x[reps])
        ys.append(y[reps])
    return np.stack(xs), np.stack(ys)
