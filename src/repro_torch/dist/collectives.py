"""Collective contracts of the federated round, the port of
``repro.dist.collectives``. This slice carries ``ParticipationSpec``, the
elastic-participation contract the round's weighted vote reads; the
``VoteWire`` family and its ``torch.distributed`` collectives arrive with the
packed wires (ROADMAP.md queue 1, item 6)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParticipationSpec:
    """Elastic participation: per-worker vote weights (FedCom-style data-volume
    weighting), a quorum expressed as a FRACTION of realized participation,
    and a per-round report-dropout rate (crashes, stragglers past the round
    deadline).

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
