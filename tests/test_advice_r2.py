"""Regression tests for the round-2 advisor findings (ADVICE.md r2).

1. high   jax_codec ycc420 batched decode: overflow-index padding must use an
          out-of-bounds POSITIVE sentinel (negative indices wrap in JAX and
          corrupted the last image's blocks).
2. medium encode_batch(..., restart_interval=) must fall back to a host
          splice when a dense stream overflows the device budget, not raise.
"""
import numpy as np
import pytest

from jpezy_tpu.codec import jax_codec


def _noise_batch(n, h, w, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)


class TestOverflowIndexPadding:
    def test_noise_decode_batch_matches_single(self):
        """Noise blocks exceed the K=10 sparse slots, exercising the
        overflow scatter + its padded sentinel rows (ADVICE r2 high).

        Compared against a one-stream batch on the SAME transport (the
        ycc420 transport has a documented few-LSB clamp-order tolerance vs
        the rgb transport, so cross-transport equality is not the contract;
        the bug being regression-tested corrupted whole blocks, diff ~99).
        """
        pytest.importorskip("jpezy_tpu.runtime.native")
        batch = _noise_batch(3, 64, 64)
        streams = jax_codec.encode_batch(batch)
        out, _ = jax_codec.decode_batch(streams, transport="ycc420")
        for i in range(3):
            single, _ = jax_codec.decode_batch(
                [streams[i]], transport="ycc420")
            assert np.array_equal(out[i], single[0]), (
                f"image {i}: max diff "
                f"{np.abs(out[i].astype(int) - single[0].astype(int)).max()}"
            )
        # and the ycc420 transport stays within its documented envelope of
        # the reference-semantics rgb transport (clamp-order LSBs only)
        ref, _ = jax_codec.decode_batch(streams, transport="rgb")
        assert np.abs(out.astype(int) - ref.astype(int)).max() <= 8


class TestRestartBudgetOverflow:
    def test_dense_restart_batch_falls_back_to_host_splice(self):
        """A 256x256 noise image runs ~2.6 bits/px, over the batched ~1
        bit/px budget; the restart path must splice on host, not raise."""
        batch = _noise_batch(2, 256, 256, seed=11)
        # default (ycc420) transport = the same host-f64-color path as
        # encode(), so the fallback's bytes are byte-equal to the single
        streams = jax_codec.encode_batch(batch, restart_interval=4)
        for i in range(2):
            single = jax_codec.encode(
                batch[i, ..., 0], batch[i, ..., 1], batch[i, ..., 2],
                restart_interval=4,
            )
            assert streams[i] == single

    def test_dense_restart_sharded_grows_budget(self):
        """encode_sharded re-dispatches with a fitted budget on overflow."""
        import jax
        from jpezy_tpu.parallel.api import encode_sharded
        from jpezy_tpu.parallel.mesh import make_mesh

        if len(jax.devices()) < 2:
            pytest.skip("needs a multi-device mesh")
        mesh = make_mesh(data=2, tile=1)
        batch = _noise_batch(2, 64, 64, seed=13)
        streams = encode_sharded(mesh, batch, restart_interval=2)
        for i in range(2):
            single = jax_codec.encode(
                batch[i, ..., 0], batch[i, ..., 1], batch[i, ..., 2],
                restart_interval=2,
            )
            assert streams[i] == single
