"""Choices that depend on the backend or the environment: the compile-cache
placement, the packer, the scan mode, the fast DCT's matmul precision, and
the float64 path's rounding (exact parity with the oracle at real size)."""
from __future__ import annotations

import importlib.util
import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jpezy_tpu.codec import oracle
from jpezy_tpu.ops import colorspace as C
from jpezy_tpu.ops import dct as D
from jpezy_tpu.ops import entropy as E
from jpezy_tpu.ops import entropy_decode as ED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [True, False],
                         ids=["env-set", "env-unset"])
def test_compile_cache_placement(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it and enable() sets
    nothing; unset: the cache goes to the fixed <repo>/.xla_cache."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    code = ("import jax; from jpezy_tpu.utils import compile_cache; "
            "compile_cache.enable(); "
            "print(jax.config.jax_compilation_cache_dir)")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    want = str(tmp_path) if env_dir else os.path.join(REPO, ".xla_cache")
    assert res.stdout.strip().splitlines()[-1] == want


@pytest.mark.parametrize("env,want", [
    (None, "reduce"), ("pallas", "reduce"), ("fori", "fori"),
    ("prefix", "prefix")])
def test_pack_method(env, want, monkeypatch):
    """Three plain-XLA packers; no kernel option is left to select."""
    if env is None:
        monkeypatch.delenv("JPEZY_PACK", raising=False)
    else:
        monkeypatch.setenv("JPEZY_PACK", env)
    assert E.pack_method() == want
    assert list(inspect.signature(E.pack_block_words).parameters) == [
        "hi", "lo", "nbits"]
    assert importlib.util.find_spec("jpezy_tpu.ops.pack_pallas") is None


@pytest.mark.parametrize("backend", ["gpu", "cpu", "rocm"])
def test_scan_mode_default_per_backend(backend, monkeypatch):
    """'lut' on every backend (the H100 ran it faster than 'chain'); no
    backend branch is left.  JPEZY_SCAN still selects either mode."""
    monkeypatch.delenv("JPEZY_SCAN", raising=False)
    monkeypatch.setattr(ED.jax, "default_backend", lambda: backend)
    assert ED.scan_mode() == "lut"
    monkeypatch.setenv("JPEZY_SCAN", "chain")
    assert ED.scan_mode() == "chain"
    monkeypatch.setenv("JPEZY_SCAN", "bogus")
    assert ED.scan_mode() == "lut"


@pytest.mark.parametrize("fn", [D.forward_dct, D.inverse_dct],
                         ids=["forward", "inverse"])
def test_fast_dct_matmul_is_highest(fn):
    """A float32 product left at default precision may run in TF32 on a
    GPU; both fast transforms pin HIGHEST."""
    jaxpr = jax.make_jaxpr(fn)(jnp.zeros((4, 64), jnp.int32))
    precs = [e.params["precision"] for e in jaxpr.jaxpr.eqns
             if e.primitive.name == "dot_general"]
    assert precs and all(
        p == (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
        for p in precs)


def test_exact_rgb_to_ycc_matches_oracle():
    """Every (r, g) pair at 16 blue levels: the jitted float64 conversion
    rounds each product like numpy (a contracted multiply-add does not).
    float64 comes from jax_enable_x64, set in tests/conftest.py."""
    r, g, b = np.meshgrid(np.arange(256), np.arange(256),
                          np.arange(0, 256, 17), indexing="ij")
    r, g, b = (x.reshape(-1).astype(np.uint8) for x in (r, g, b))
    got = jax.jit(lambda *p: C.rgb_to_ycc(*p, jnp.float64))(r, g, b)
    for a, w in zip(got, oracle.rgb_to_ycc(r, g, b)):
        assert np.array_equal(np.asarray(a), w)


def test_exact_ycc_to_rgb_matches_oracle():
    rng = np.random.default_rng(3)
    y, cb, cr = (rng.integers(-700, 1000, 1 << 20).astype(np.int32)
                 for _ in range(3))
    got = jax.jit(lambda *p: C.ycc_to_rgb(*p, jnp.float64))(y, cb, cr)
    for a, w in zip(got, oracle.ycc_to_rgb(y, cb, cr)):
        assert np.array_equal(np.asarray(a), w)


def test_exact_codec_512_matches_oracle():
    """precision='exact' at 512x512: streams byte-identical to the oracle
    and decode pixel-identical (chip_smoke.py's exact phase)."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    cs.phase_exact(cs.Report("CPU test"), cs.make_test_image(512, 512), 8)
