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


def test_plain_versions_barred_covers_the_trainer_path():
    """chip_smoke.py bars every plain version on the trainer's path while it
    counts launches: each name it patches exists, a barred one raises, and
    leaving the block restores it."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    import torch

    from repro_torch.core import engine
    from repro_torch.core.algorithm import CompressionConfig
    from repro_torch.dist.collectives import make_vote_wire
    from repro_torch.launch.mesh import make_mesh

    wire = make_vote_wire("allgather_packed", make_mesh((1,), ("data",)))
    g = torch.ones(600)
    with chip_smoke.plain_versions_barred():
        with pytest.raises(RuntimeError, match="plain version"):
            engine.compress_leaf(g, CompressionConfig(), 1, wire=wire)
    assert engine.compress_leaf(g, CompressionConfig(), 1, wire=wire).values.shape == (32, 128)
