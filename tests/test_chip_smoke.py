"""chip_smoke.py's phases on the CPU at tiny sizes, and its refusal to run
without a GPU.  The real sizes run on the card (tests/test_gpu_device.py)."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

RI = 2


@pytest.fixture(scope="module")
def rep():
    return cs.Report("CPU test")


@pytest.fixture(scope="module")
def batch():
    return cs.images(2, 32, 48)


@pytest.fixture(scope="module")
def streams(rep, batch):
    return cs.phase_encode(rep, batch, RI)


def test_phase_encode(streams):
    std, dri = streams
    assert len(std) == len(dri) == 2
    assert all(s[:2] == b"\xff\xd8" for s in std + dri)


def test_phase_decode(rep, batch, streams):
    cs.phase_decode(rep, batch, *streams)


def test_phase_scan(rep, streams):
    assert cs.phase_scan(rep, streams[1], streams[0], RI) in ("chain", "lut")


def test_phase_pipeline(rep):
    cs.phase_pipeline(rep, [cs.images(2, 32, 32, seed=10 + 2 * j)
                            for j in range(3)], RI)


def test_phase_single(rep):
    cs.phase_single(rep, cs.make_test_image(64, 48, seed=3), RI)


def test_phase_noise(rep):
    noise = np.random.default_rng(1).integers(0, 256, (48, 64, 3), np.uint8)
    cs.phase_noise(rep, noise)


def test_phase_cli(rep, tmp_path, monkeypatch):
    # a set JAX_COMPILATION_CACHE_DIR keeps the CLI's cache setup a no-op
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    cs.phase_cli(rep, cs.make_test_image(32, 64, seed=5), str(tmp_path))


def test_phase_memory(rep, batch, streams, capsys):
    cs.phase_memory(rep, batch, streams[1], RI)
    out = capsys.readouterr().out
    assert "fused encode" in out and "fused device decode" in out


def test_phase_exact(rep, batch):
    cs.phase_exact(rep, batch[0], RI)


def test_phase_four(rep):
    cs.phase_four(rep, jax.devices()[:4], cs.images(2, 32, 32),
                  cs.make_test_image(64, 32, seed=7), RI)


def test_main_refuses_cpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "needs a GPU" in out.err


def test_fails_outside_the_repo(tmp_path):
    """Alone in a directory, the script cannot import the codec: it exits
    non-zero and prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
