"""chip_smoke.py must fail loudly without a card: a non-zero exit and no
``"ok": true`` line, so the port's main path can never pass on the CPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(script: pathlib.Path, cwd: pathlib.Path):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "CUDA_VISIBLE_DEVICES": "",
           "HOME": os.environ.get("HOME", str(cwd))}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=60)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":  # a directory that holds chip_smoke.py and nothing else
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = _run(script, script.parent)
    assert proc.returncode != 0, proc.stdout
    assert '"ok": true' not in proc.stdout
