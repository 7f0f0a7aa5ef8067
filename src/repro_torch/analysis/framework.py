"""The shared Rule/Finding/report skeleton of every analysis pass, the port's
copy of ``repro.analysis.framework``.

A ``Rule`` is a named, declarative check. Each pass hands its rules whatever
artifact it analyzes (a recorded collective census, a python AST, a profiled
launch count) and the rule answers with ``Finding``s — never by raising. A ``Report`` aggregates
findings across rules and renders them; the CLI exit code is
``report.exit_code()``. Severity ``error`` blocks; ``info`` is advisory
context (e.g. census byte tables) printed but never failing.

Adding a rule = subclass ``Rule``, set ``name``/``description``, implement a
``check(...)`` returning ``list[Finding]`` (use ``self.finding(...)``), and
register it with the pass that owns its artifact type.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

SEVERITIES = ("error", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation (or advisory note) at one location.

    ``where`` is whatever locates the artifact: ``path:line`` for AST rules, a
    program label (e.g. ``step[pack8]``) for census and launch rules.
    """

    rule: str
    where: str
    message: str
    severity: str = "error"

    def __post_init__(self):
        assert self.severity in SEVERITIES, self.severity

    def render(self) -> str:
        return f"[{self.severity}] {self.rule}: {self.where}: {self.message}"


class Rule:
    """Base class: a named check producing findings.

    Subclasses define ``check(...)`` with whatever signature their pass calls
    them with; the contract is only that it returns ``list[Finding]``.
    """

    name: str = "rule"
    description: str = ""

    def finding(self, where: str, message: str, *, severity: str = "error") -> Finding:
        return Finding(rule=self.name, where=where, message=message,
                       severity=severity)

    def check(self, *args, **kwargs) -> "list[Finding]":
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Report:
    """Aggregated findings of one analysis run."""

    findings: tuple
    checks: int = 0   # how many rule evaluations ran (a 0-finding report with
                      # 0 checks is a configuration bug, not a clean bill)

    @property
    def errors(self) -> tuple:
        return tuple(f for f in self.findings if f.severity == "error")

    @property
    def ok(self) -> bool:
        return not self.errors

    def exit_code(self) -> int:
        return 0 if self.ok else 1

    def render(self) -> str:
        lines = [f.render() for f in self.findings]
        verdict = "OK" if self.ok else "FAIL"
        lines.append(f"{verdict}: {self.checks} checks, "
                     f"{len(self.errors)} errors, "
                     f"{len(self.findings) - len(self.errors)} notes")
        return "\n".join(lines)


def report(findings: Iterable[Finding], checks: int) -> Report:
    return Report(findings=tuple(findings), checks=checks)


def merge(reports: Sequence[Report]) -> Report:
    out: list[Finding] = []
    checks = 0
    for r in reports:
        out.extend(r.findings)
        checks += r.checks
    return Report(findings=tuple(out), checks=checks)
