"""``python -m repro_torch.analysis [--device cpu]``: run every pass of the
port's analysis gate and exit nonzero on any error finding.

Order, as JAX's gate: the AST repo-lint; the fused wire ops against their
plain chains (and, on the card, one launch each); the wire-mode collective
censuses (per leaf, bucketed, on the ring); the launch-count budgets (with
the bucketed >= 5x floor on the stacked-block configs); the elastic gate
(censuses, counts, a dropped worker's payload all zeros); the entropy-wire
byte floor; the ring's residency floor. The steps run on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.analysis import drivers, report
    from repro_torch.analysis.framework import merge
    from repro_torch.analysis.repolint import run_repolint

    device = str(resolve_device(args.device))
    passes = [("repolint", run_repolint),
              ("spec rules", lambda: drivers.run_spec_checks(device)),
              ("collective census", lambda: drivers.run_census_checks(device=device)),
              ("collective counts", lambda: drivers.run_count_checks(device=device)),
              ("participation wire", lambda: drivers.run_participation_checks(device=device)),
              ("entropy wire budget", drivers.entropy_wire_checks),
              ("gather hbm budget", drivers.gather_hbm_checks)]
    reports = []
    for name, fn in passes:
        t0 = time.perf_counter()
        findings, checks = fn()
        reports.append(report(findings, checks))
        print(f"{name}: {checks} checks, {len(findings)} findings, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    rep = merge(reports)
    print(rep.render())
    return rep.exit_code()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
