"""`repro_torch.analysis`, the port's counterpart of ``repro.analysis``: the
rule-based checks of the port, one ``Rule``/``Finding``/``report``
framework (``analysis.framework``), four passes:

  repolint  AST architecture lint: no compressor name branching outside
            ``core/compressors.SPECS``, no raw ``torch.distributed``
            payload collectives outside ``dist/collectives.py``, SPECS
            completeness; zero-entry allowlist.
  drivers   the collective census: tiny-model steps run at M = 16 workers
            with ``collectives.record_collectives`` open, every wire mode
            per leaf, bucketed and on the ring, their bytes pinned to the
            VoteWire ledger and their launches to the mode's budget; the
            elastic censuses and MaskedPayloadZero; the entropy-wire and
            ring residency floors; the fused wire ops against their plain
            chains (and, on the card, one launch each).
  rules     the rules those drivers apply.

JAX's jaxpr and HLO walkers (``jaxpr_audit``'s ``NoHbmIntermediate`` and
``DtypePromotionDrift``, ``hlo_audit``) have no PyTorch counterpart.
``python -m repro_torch.analysis`` runs everything and exits nonzero on any
error finding.
"""

from repro_torch.analysis.framework import Finding, Report, Rule, report

__all__ = ["Finding", "Report", "Rule", "report"]
