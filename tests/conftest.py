"""Test config: run JAX on a virtual 8-device CPU mesh so the suite is
hermetic (no accelerator needed) and sharding tests exercise real
multi-device paths.  The platform is pinned through jax.config before any
backend is initialized.  Tests that need a GPU carry the `gpu` marker and
skip here (tests/test_gpu_device.py).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
# x64 so precision="exact" (float64, bit-identical to the reference's double
# math) is testable alongside the float32 fast path.
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

from imagegen import make_test_image


@pytest.fixture(scope="session")
def lena_rgb():
    """Deterministic 512x512 test image (synthetic; no network fetch)."""
    return make_test_image(512, 512, seed=0)


@pytest.fixture(scope="session")
def small_rgb():
    return make_test_image(64, 48, seed=1)


@pytest.fixture(scope="session")
def odd_rgb():
    """Non-multiple-of-16 dims to exercise edge replication + crop."""
    return make_test_image(41, 67, seed=2)
