"""Does torch.profiler still see the port's kernels after large traces in
one process? On one NVIDIA GPU: the analysis gate's fused-op launch check
(``repro_torch.analysis.drivers.fused_launch_check``, every fused wire op of
the registry) in a fresh process, then again after one traced call of 10,000,
100,000 and 400,000 small kernels each; prints each check's findings (a
blind profiler reads "torch.profiler saw no device activity"). Why
``chip_smoke.py`` runs the gate in a process of its own. From the
repository root:

    python3 benchmarks/torch_profiler_probe.py
"""
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.analysis import drivers  # noqa: E402
from repro_torch.core.compressors import SPECS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def check_all(tag: str) -> None:
    t0 = time.perf_counter()
    findings = []
    for spec in SPECS.values():
        if spec.fused_pack_op is not None:
            findings += drivers.fused_launch_check(spec)
    print(f"{tag} findings {len(findings)} {[f.message for f in findings][:2]} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profiler_probe: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi())
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
    check_all("fresh:")
    x = torch.randn(1024, device="cuda")
    for n in (10_000, 100_000, 400_000):
        def many():
            y = x
            for _ in range(n):
                y = y + 1
        t0 = time.perf_counter()
        split = cs.profile_call(torch, many)
        print(f"trace of {n}: {split['kernels']} kernels seen, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check_all(f"after a trace of {n}:")
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
