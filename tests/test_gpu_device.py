"""The codec's main path on a real GPU, through chip_smoke.py.

The hermetic suite pins the CPU (conftest.py), so this test runs
chip_smoke.py in a child process that keeps JAX's default backend.  It
skips where no GPU is visible.  Run it on a GPU machine with

    python -m pytest tests/test_gpu_device.py -m gpu -q
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gpu_visible() -> bool:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return False
    res = subprocess.run([smi, "-L"], capture_output=True, text=True,
                         timeout=60)
    return res.returncode == 0 and "GPU" in res.stdout


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    if not _gpu_visible():
        pytest.skip("no GPU visible (nvidia-smi -L)")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=1500)
    assert res.returncode == 0, (res.stdout[-4000:], res.stderr[-4000:])
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] is True
    assert last["device"]["platform"] == "gpu"
    assert last["device"]["count"] >= 1
