"""chip_smoke.py's refusal paths: without a GPU, or without the package
beside it, it must exit non-zero and never print the `ok` result line."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _run(cwd: Path, script: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, str(script)],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    res = _run(REPO, REPO / "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_refuses_without_package(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", script)
    res = _run(tmp_path, script)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "package is missing" in res.stderr
