"""The port's counterparts of the rules of ``repro.analysis.jaxpr_audit``
that need no jaxpr: each reads a ``collectives.Census`` recorded while a
step ran (``collectives.record_collectives``), a ledger's arithmetic, or
a launch count taken on the card.

  CollectiveCensus      recorded payload bytes == the VoteWire ledger, and
                        the billed scalars == its protocol scalars; a
                        collective with no byte model blocks
  CollectiveCountBudget payload launches == the mode's budget exactly,
                        scalar launches under a cap
  EntropyWireBudget     golomb beats the flat 2-bit wire by a floor
  GatherHbmBudget       the ring's gathered payload undercuts the
                        monolithic gather's by a floor
  MaskedPayloadZero     a dropped worker's integer gather payload is all
                        zeros (JAX's holds the mask's select in the jaxpr;
                        here the recorder looks at the bytes)
  FusedEqualsPlain      a fused wire op's bytes == its plain two-pass chain
  FusedOneLaunch        a fused wire op is one of the port's kernels and no
                        intermediate of the gradient's size (JAX's
                        ``NoHbmIntermediate``), on the card only

JAX's ``DtypePromotionDrift``, ``NoHbmIntermediate`` by jaxpr and
``HloJaxprAgreement`` have no counterpart here (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.analysis.framework import Rule
from repro_torch.dist.collectives import Census


class CollectiveCensus(Rule):
    """Pin a step's recorded collective bytes against the VoteWire ledger.

    Array payloads (two elements or more, role ``wire``) must equal the
    ledger's payload term exactly (within ``tolerance``, 0 by default: the
    ledger is built from the same padded buffer sizes the collectives
    ship), and the billed scalars (decode scales, weights, the shared L-inf
    max) its scalar term exactly. Metric scalars (loss, nnz, counts) are not
    billed and are reported as a note."""

    name = "collective-census"
    description = "recorded collective bytes must match the VoteWire ledger"

    def __init__(self, tolerance: float = 0.0):
        self.tolerance = float(tolerance)

    def check(self, label: str, census: Census, *, ledger_payload: float,
              ledger_scalar: float) -> list:
        findings = []
        if census.unknown:
            names = ", ".join(sorted({f"{r.primitive}({r.in_bytes}B)" for r in census.unknown}))
            findings.append(self.finding(
                label,
                f"{len(census.unknown)} collective call(s) the byte model does not cover: "
                f"{names} — an unmodeled collective billed at zero bytes voids the ledger "
                f"pin; teach CollectiveRecord.ring_bytes its model"))
        payload = census.payload_bytes()
        tol = self.tolerance * max(abs(ledger_payload), 1.0)
        if abs(payload - ledger_payload) > tol:
            findings.append(self.finding(
                label,
                f"collective array-payload bytes {payload:.1f} != VoteWire ledger "
                f"{ledger_payload:.1f} (census: {census.counts()})"))
        scal = census.scalar_bytes()
        if abs(scal - ledger_scalar) > self.tolerance * max(abs(ledger_scalar), 1.0):
            findings.append(self.finding(
                label,
                f"billed scalar collective bytes {scal:.1f} != the ledger's protocol "
                f"scalars {ledger_scalar:.1f}"))
        return findings


class CollectiveCountBudget(Rule):
    """Pin a step's collective LAUNCH counts: array-payload launches equal
    the mode's budget exactly (per leaf one-ish a leaf, bucketed one-ish a
    bucket, the ring one a chunk), scalar launches at most ``max_scalar``."""

    name = "collective-count"
    description = "recorded collective launch counts must match the mode budget"

    def check(self, label: str, census: Census, *, expected_payload: int,
              max_scalar: Optional[int] = None) -> list:
        findings = []
        got = census.payload_count()
        if got != int(expected_payload):
            findings.append(self.finding(
                label,
                f"{got} array-payload collective launches a step, budget says exactly "
                f"{expected_payload} (census: {census.counts()})"))
        if max_scalar is not None and census.scalar_count() > int(max_scalar):
            findings.append(self.finding(
                label,
                f"{census.scalar_count()} scalar collective launches a step exceed the "
                f"protocol budget {max_scalar}"))
        return findings


class EntropyWireBudget(Rule):
    """The golomb wire's billed bytes (capacity padding included) must
    undercut the flat 2-bit wire's by ``min_ratio`` at the plan sparsity."""

    name = "entropy-wire-budget"
    description = ("golomb wire bytes (capacity padding included) must beat the flat 2-bit "
                   "wire by the configured floor")

    def __init__(self, min_ratio: float = 2.0):
        self.min_ratio = float(min_ratio)

    def check(self, label: str, *, golomb_bytes: float, pack2_bytes: float) -> list:
        if golomb_bytes * self.min_ratio > pack2_bytes:
            ratio = pack2_bytes / max(golomb_bytes, 1e-9)
            return [self.finding(
                label,
                f"golomb wire bills {golomb_bytes:.0f} B vs {pack2_bytes:.0f} B on the flat "
                f"2-bit wire — ratio {ratio:.2f}x is under the {self.min_ratio:.1f}x floor")]
        return []


class GatherHbmBudget(Rule):
    """The ring's peak gathered payload (``gather_hbm_bytes``) must undercut
    the monolithic gather's by ``min_ratio``."""

    name = "gather-hbm-budget"
    description = ("ring gather peak payload memory must undercut the monolithic gather by "
                   "the configured floor")

    def __init__(self, min_ratio: float):
        self.min_ratio = float(min_ratio)

    def check(self, label: str, *, ring_bytes: float, mono_bytes: float) -> list:
        if ring_bytes * self.min_ratio > mono_bytes:
            ratio = mono_bytes / max(ring_bytes, 1e-9)
            return [self.finding(
                label,
                f"ring gather peaks at {ring_bytes:.0f} B of gathered payload vs "
                f"{mono_bytes:.0f} B monolithic — ratio {ratio:.2f}x is under the "
                f"{self.min_ratio:.1f}x floor")]
        return []


class MaskedPayloadZero(Rule):
    """Every integer gather payload (a monolithic gather or a ring's hop
    loop) must carry all zeros from a worker whose report was dropped: a
    fixed-shape gather ships its bytes anyway, and stale nonzero bytes would
    vote. ``dropped`` holds the flat indices of the round's dropped
    workers; a step with gather payloads and none dropped proves nothing, so
    that blocks too. A step with no integer gather (the psum wires) passes,
    as JAX's rule finds no site there."""

    name = "masked-payload-zero"
    description = "a dropped worker's integer gather payload must be all zeros"

    def check(self, label: str, census: Census, dropped) -> list:
        dropped = set(int(w) for w in dropped)
        sites = [r for r in census.records
                 if r.role == "wire" and r.zero_workers
                 and r.primitive in ("all_gather", "ppermute")]
        if not sites:   # a psum wire: its sum is taken of masked votes
            return []
        if not dropped:
            return [self.finding(label, "no worker was dropped: the rule saw nothing to hold")]
        findings = []
        for r in sites:
            bad = sorted(w for w in dropped
                         if 0 <= w - r.first_worker < len(r.zero_workers)
                         and not r.zero_workers[w - r.first_worker])
            if bad:
                findings.append(self.finding(
                    label,
                    f"{r.primitive} of a {r.dtype}[{r.in_elems}] payload ships nonzero bytes "
                    f"from dropped worker(s) {bad} — a non-reporting worker's stale bytes "
                    f"would vote"))
        return findings


class FusedEqualsPlain(Rule):
    """A fused wire op (``CompressorSpec.fused_pack_op``) writes the bytes of
    its plain chain: the spec's plain values, then its format's plain pack."""

    name = "fused-equals-plain"
    description = "a fused wire op's bytes equal its plain two-pass chain"

    def check(self, label: str, got, want) -> list:
        if tuple(got.shape) != tuple(want.shape):
            return [self.finding(label, f"shape {tuple(got.shape)} != the plain chain's "
                                        f"{tuple(want.shape)}")]
        differ = int((got != want).sum())
        if differ:
            return [self.finding(label, f"{differ} bytes differ from the plain chain")]
        return []


class FusedOneLaunch(Rule):
    """A fused wire op (``CompressorSpec.fused_pack_op``) on the card: one
    ``engine.compress_leaf`` launches one of the port's kernels, the fused
    encoder, by its wrapper's count (``wrapper_launches``, the counts that
    moved) and by ``torch.profiler``'s kernels (``port_kernels``, of
    ``device_kernels`` device activities seen); and the op itself allocates
    nothing beyond its output (``extra_bytes`` within ``slack_bytes``): no
    int8 ternary or float intermediate of the gradient's size reaches
    memory."""

    name = "fused-one-launch"
    description = "a fused wire op is one kernel launch and no gradient-sized intermediate"

    #: the wrappers of the fused encoders
    ENCODERS = ("sparsign_pack2bit", "ternary_pack2bit", "sparsign_golomb", "qsgd8_pack8")

    def __init__(self, slack_bytes: int = 2 << 20):
        self.slack_bytes = int(slack_bytes)

    def check(self, label: str, *, wrapper_launches: dict, port_kernels: list,
              device_kernels: int, encoder: str, extra_bytes: int) -> list:
        findings = []
        if (sum(wrapper_launches.values()) != 1
                or not any(wrapper_launches.get(e) == 1 for e in self.ENCODERS)):
            findings.append(self.finding(
                label, f"compress_leaf launched the port's wrappers {wrapper_launches}, not "
                       f"one fused encoder"))
        if not device_kernels:
            findings.append(self.finding(label, "torch.profiler saw no device activity"))
        elif len(port_kernels) != 1 or encoder not in port_kernels[0]:
            findings.append(self.finding(
                label, f"torch.profiler saw the port's kernels {port_kernels} of "
                       f"{device_kernels} device activities, not the one fused encoder "
                       f"({encoder})"))
        if extra_bytes > self.slack_bytes:
            findings.append(self.finding(
                label, f"the fused op allocated {extra_bytes} B beyond its output (more than "
                       f"{self.slack_bytes} B): an intermediate reached memory"))
        return findings
