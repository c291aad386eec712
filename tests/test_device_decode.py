"""Device-side entropy decode (transport='device') vs the host frontend.

The device decoder (ops/entropy_decode.py) must reproduce the host C++
frontend bit-for-bit on restart-interval streams: same canonical walk,
sign extension (T.81 F.2.2.1), ZRL/EOB control, de-zigzag and per-segment
DC predictor resets (referent: jpezy_decoder.hpp:583-642,152-163).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from jpezy_tpu.codec import jax_codec
from jpezy_tpu.bitstream.reader import parse

native = pytest.importorskip("jpezy_tpu.runtime.native")
try:
    native.get_lib()
except Exception:
    pytest.skip("g++ build unavailable", allow_module_level=True)


def split(rgb):
    return rgb[..., 0], rgb[..., 1], rgb[..., 2]


class TestDecodeSegments:
    """The raw lockstep kernel against the host entropy decoder."""

    @pytest.mark.parametrize("ri,hw,seed", [
        (2, (64, 48), 0), (4, (64, 80), 1), (3, (48, 48), 2),
    ])
    def test_blocks_bitexact_vs_host(self, ri, hw, seed):
        from imagegen import make_test_image
        from jpezy_tpu.ops.entropy_decode import (
            build_decode_lut, decode_segments)

        h, w = hw
        img = make_test_image(h, w, seed=seed)
        data = jax_codec.encode(*split(img), restart_interval=ri)
        pj = parse(data)
        nmcu = ((h + 15) // 16) * ((w + 15) // 16)
        ref = native.entropy_decode(pj, nmcu)      # host C++ frontend

        d = np.frombuffer(pj.data, np.uint8)[pj.entropy_start:]
        offs = native.find_restart_offsets(d, nmcu, ri)
        nseg = len(offs)
        ends = np.append(offs[1:], len(d))
        L = 64
        while L < int((ends - offs).max()) + 8:
            L *= 2
        rows = np.zeros((nseg, L), np.uint8)
        native.destuff_segments(d, offs, rows)
        words = rows.view(">u4").astype("=u4")
        nblk = (np.minimum(ri, nmcu - np.arange(nseg) * ri) * 6).astype(
            np.int32)
        blocks, bad = decode_segments(
            jnp.asarray(words), jnp.asarray(nblk),
            jnp.asarray(build_decode_lut(pj.huff)), max_blocks=ri * 6)
        blocks = np.asarray(blocks)
        assert not np.asarray(bad).any()

        b6 = blocks.reshape(nseg * ri, 6, 64)[:nmcu]
        got = [b6[:, :4].reshape(nmcu * 4, 64), b6[:, 4], b6[:, 5]]
        for c in range(3):
            assert np.array_equal(got[c], ref[c]), f"component {c}"

    def test_noise_content_wide_coefficients(self):
        """Noise maxes out coefficient magnitudes and symbol counts (no
        sparse-overflow concept on this path -- int16 all the way)."""
        from jpezy_tpu.ops.entropy_decode import (
            build_decode_lut, decode_segments)

        rng = np.random.default_rng(7)
        img = rng.integers(0, 256, (64, 64, 3), np.uint8)
        data = jax_codec.encode(*split(img), restart_interval=1)
        pj = parse(data)
        nmcu = 16
        ref = native.entropy_decode(pj, nmcu)
        d = np.frombuffer(pj.data, np.uint8)[pj.entropy_start:]
        offs = native.find_restart_offsets(d, nmcu, 1)
        ends = np.append(offs[1:], len(d))
        L = 64
        while L < int((ends - offs).max()) + 8:
            L *= 2
        rows = np.zeros((nmcu, L), np.uint8)
        native.destuff_segments(d, offs, rows)
        blocks, bad = decode_segments(
            jnp.asarray(rows.view(">u4").astype("=u4")),
            jnp.full(nmcu, 6, np.int32),
            jnp.asarray(build_decode_lut(pj.huff)), max_blocks=6)
        blocks = np.asarray(blocks)
        assert not np.asarray(bad).any()
        b6 = blocks.reshape(nmcu, 6, 64)
        got = [b6[:, :4].reshape(nmcu * 4, 64), b6[:, 4], b6[:, 5]]
        for c in range(3):
            assert np.array_equal(got[c], ref[c]), f"component {c}"


class TestDeviceTransport:
    def test_batch_matches_ycc420_transport(self):
        from imagegen import make_test_image

        batch = np.stack([make_test_image(64, 64, seed=i) for i in range(3)])
        streams = jax_codec.encode_batch(batch, restart_interval=2)
        a, _ = jax_codec.decode_batch(streams, transport="device")
        b, _ = jax_codec.decode_batch(streams, transport="ycc420")
        assert np.array_equal(a, b)

    def test_single_image(self, small_rgb):
        data = jax_codec.encode(*split(small_rgb), restart_interval=2)
        ra, ga, ba, _ = jax_codec.decode(data, transport="device")
        rb, gb, bb, _ = jax_codec.decode(data, transport="ycc420")
        assert np.array_equal(np.stack([ra, ga, ba]),
                              np.stack([rb, gb, bb]))

    def test_rejects_restart_free(self, small_rgb):
        data = jax_codec.encode(*split(small_rgb))
        with pytest.raises(ValueError):
            jax_codec.decode_batch([data], transport="device")

    def test_tail_segment(self):
        """nmcu not divisible by the restart interval: the last segment
        decodes fewer MCUs and the padding blocks stay zero."""
        from imagegen import make_test_image

        img = make_test_image(48, 80, seed=9)      # 15 MCUs
        data = jax_codec.encode(*split(img), restart_interval=4)
        ra = np.stack(jax_codec.decode(data, transport="device")[:3])
        rb = np.stack(jax_codec.decode(data, transport="ycc420")[:3])
        assert np.array_equal(ra, rb)


class TestScanModes:
    """The default symbol decode depends on the backend
    (entropy_decode.scan_mode; 'lut' on the CPU) -- exercise BOTH table
    kinds and the unroll knob explicitly so every mode is covered
    regardless of backend."""

    def _segments(self, seed=7, ri=3, hw=(48, 64)):
        from imagegen import make_test_image

        h, w = hw
        img = make_test_image(h, w, seed=seed)
        data = jax_codec.encode(*split(img), restart_interval=ri)
        pj = parse(data)
        nmcu = ((h + 15) // 16) * ((w + 15) // 16)
        d = np.frombuffer(pj.data, np.uint8)[pj.entropy_start:]
        offs = native.find_restart_offsets(d, nmcu, ri)
        nseg = len(offs)
        ends = np.append(offs[1:], len(d))
        L = 64
        while L < int((ends - offs).max()) + 8:
            L *= 2
        rows = np.zeros((nseg, L), np.uint8)
        lens = np.zeros(nseg, np.int64)
        native.destuff_segments(d, offs, rows, lens)
        words = rows.view(">u4").astype("=u4")
        nblk = (np.minimum(ri, nmcu - np.arange(nseg) * ri) * 6).astype(
            np.int32)
        return pj, words, nblk, lens.astype(np.int32), ri

    def test_chain_equals_lut_and_host(self):
        from jpezy_tpu.ops.entropy_decode import (
            build_decode_chain_tables, build_decode_lut, decode_segments)

        pj, words, nblk, rawlen, ri = self._segments()
        outs = {}
        for name, tabs in (("lut", build_decode_lut(pj.huff)),
                           ("chain", build_decode_chain_tables(pj.huff))):
            blocks, bad = decode_segments(
                jnp.asarray(words), jnp.asarray(nblk), jnp.asarray(tabs),
                None, jnp.asarray(rawlen), max_blocks=ri * 6)
            assert not np.asarray(bad).any(), name
            outs[name] = np.asarray(blocks)
        assert np.array_equal(outs["lut"], outs["chain"])

    @pytest.mark.parametrize("unroll", [2, 3])
    def test_unroll_invariant(self, unroll):
        from jpezy_tpu.ops.entropy_decode import (
            build_decode_chain_tables, decode_segments)

        pj, words, nblk, rawlen, ri = self._segments(seed=8)
        tabs = jnp.asarray(build_decode_chain_tables(pj.huff))
        ref, bad0 = decode_segments(
            jnp.asarray(words), jnp.asarray(nblk), tabs, None,
            jnp.asarray(rawlen), max_blocks=ri * 6, unroll=1)
        got, bad1 = decode_segments(
            jnp.asarray(words), jnp.asarray(nblk), tabs, None,
            jnp.asarray(rawlen), max_blocks=ri * 6, unroll=unroll)
        assert np.array_equal(np.asarray(ref), np.asarray(got))
        assert not np.asarray(bad0).any() and not np.asarray(bad1).any()

    def test_chain_flags_corruption(self):
        from jpezy_tpu.ops.entropy_decode import (
            build_decode_chain_tables, decode_segments)

        pj, words, nblk, rawlen, ri = self._segments(seed=9)
        words = words.copy()
        words[0] = 0xFFFFFFFF          # all-ones: invalid AC prefix walk
        _, bad = decode_segments(
            jnp.asarray(words), jnp.asarray(nblk),
            jnp.asarray(build_decode_chain_tables(pj.huff)), None,
            jnp.asarray(rawlen), max_blocks=ri * 6)
        assert np.asarray(bad)[0]


class TestPerImageTables:
    """VERDICT r4 #3: the device decoder indexes per-lane LUT sets, so
    custom/per-image DHT tables stay on the device path (the reference
    decodes arbitrary assignments, jpezy_decoder.hpp:190-256)."""

    def test_optimize_streams_on_device(self):
        """Our own optimize=True output (per-image optimal tables) -- the
        flagship restart+device round-trip config (VERDICT r4 weak #5)."""
        from imagegen import make_test_image

        batch = np.stack([make_test_image(64, 64, seed=60 + i)
                          for i in range(3)])
        streams = jax_codec.encode_batch(batch, restart_interval=2,
                                         optimize=True)
        a, _ = jax_codec.decode_batch(streams, transport="device")
        b, _ = jax_codec.decode_batch(streams, transport="ycc420")
        assert np.array_equal(a, b)

    def test_mixed_table_sets_one_batch(self):
        """Standard-table and optimal-table streams in ONE batch: the
        dedup produces T=2 LUT sets with per-lane select."""
        from imagegen import make_test_image

        batch = np.stack([make_test_image(64, 64, seed=70 + i)
                          for i in range(3)])
        std = jax_codec.encode_batch(batch, restart_interval=2)
        opt = jax_codec.encode_batch(batch, restart_interval=2,
                                     optimize=True)
        mixed = [std[0], opt[1], std[2]]
        a, _ = jax_codec.decode_batch(mixed, transport="device")
        b, _ = jax_codec.decode_batch(std, transport="ycc420")
        assert np.array_equal(a, b)

    def test_foreign_libjpeg_restart_stream(self):
        """A real libjpeg restart stream (PIL, optimized custom tables)
        decodes transport='device' bit-exact vs the host frontend."""
        import io

        Image = pytest.importorskip("PIL.Image")
        from imagegen import make_test_image

        img = make_test_image(64, 80, seed=80)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85, subsampling=2,
                                  optimize=True, restart_marker_blocks=2)
        data = buf.getvalue()
        assert b"\xff\xdd" in data                   # DRI present
        ra = np.stack(jax_codec.decode(data, transport="device")[:3])
        rb = np.stack(jax_codec.decode(data, transport="ycc420")[:3])
        assert np.array_equal(ra, rb)

    def test_mixed_quality_batch_on_device(self):
        """Per-image QUANT tables too (traced [N, 3, 64] dequant): a
        mixed-quality foreign batch decodes bit-exact per stream, while
        the host-frontend transports refuse it instead of silently
        dequantizing every image with stream 0's tables."""
        from imagegen import make_test_image

        batch = np.stack([make_test_image(64, 64, seed=90 + i)
                          for i in range(3)])
        streams = [jax_codec.encode(
            batch[i, ..., 0], batch[i, ..., 1], batch[i, ..., 2],
            restart_interval=2, quality=q)
            for i, q in enumerate((50, 75, 30))]
        pix, _ = jax_codec.decode_batch(streams, transport="device")
        for i, s in enumerate(streams):
            r, g, b, _ = jax_codec.decode(s, transport="ycc420")
            assert np.array_equal(pix[i], np.stack([r, g, b], -1)), i
        with pytest.raises(ValueError, match="uniform quant"):
            jax_codec.decode_batch(streams, transport="ycc420")

    def test_mixed_quality_batch_indexed(self):
        from imagegen import make_test_image

        batch = np.stack([make_test_image(64, 64, seed=95 + i)
                          for i in range(2)])
        streams = [jax_codec.encode(
            batch[i, ..., 0], batch[i, ..., 1], batch[i, ..., 2], quality=q)
            for i, q in enumerate((85, 40))]
        pix, _ = jax_codec.decode_batch(streams, transport="indexed")
        for i, s in enumerate(streams):
            r, g, b, _ = jax_codec.decode(s, transport="ycc420")
            assert np.array_equal(pix[i], np.stack([r, g, b], -1)), i

    def test_single_optimize_image_auto_device(self, small_rgb, monkeypatch):
        """The auto-picked decode of our optimize+restart output must stay
        on the device transport (no silent downgrade, VERDICT r4 #2)."""
        calls = []
        orig = jax_codec._decode_batch_device_dispatch

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(jax_codec, "_decode_batch_device_dispatch", spy)
        data = jax_codec.encode(*split(small_rgb), restart_interval=2,
                                optimize=True)
        auto = np.stack(jax_codec.decode(data)[:3])
        assert calls, "optimize stream fell off the device path"
        ref = np.stack(jax_codec.decode(data, transport="rgb")[:3])
        # device clamps planes to u8 before color; envelope-tested vs rgb
        assert np.mean(np.abs(auto.astype(int) - ref.astype(int))) < 0.5


class TestCorruptionDetection:
    """VERDICT r4 #4: the device transport must DETECT corrupt segments
    (per-lane bad flags: invalid windows, AC overflow, bit-consumption
    mismatch), like the reference's negative returns
    (jpezy_decoder.hpp:593,635) and our host paths' raises."""

    def _restart_stream(self, seed=90):
        from imagegen import make_test_image

        img = make_test_image(64, 64, seed=seed)
        return jax_codec.encode(*split(img), restart_interval=2)

    def test_zeroed_segment_raises(self):
        data = bytearray(self._restart_stream())
        pj = parse(bytes(data))
        d = np.frombuffer(bytes(data), np.uint8)
        i = pj.entropy_start
        while not (d[i] == 0xFF and 0xD0 <= d[i + 1] <= 0xD7):
            i += 1
        for j in range(pj.entropy_start, i):
            data[j] = 0x00
        with pytest.raises(ValueError, match="corrupt"):
            jax_codec.decode_batch([bytes(data)], transport="device")

    def test_deleted_byte_raises(self):
        """Deleting an entropy byte shifts every code after it; the
        bit-consumption check catches it deterministically (the reference
        would decode garbage until an invalid code happened by luck)."""
        data = self._restart_stream()
        pj = parse(data)
        d = np.frombuffer(data, np.uint8)
        i = pj.entropy_start
        while not (d[i] == 0xFF and 0xD0 <= d[i + 1] <= 0xD7):
            i += 1
        trunc = data[: i - 1] + data[i:]    # segment 0 one byte short
        with pytest.raises(ValueError, match="corrupt"):
            jax_codec.decode_batch([trunc], transport="device")

    def test_bitflip_sweep_detection(self):
        """Flip every bit of the first entropy bytes one at a time.  Many
        single-bit flips re-synchronize into a VALID stream of identical
        total bit length (Huffman codes are self-synchronizing) -- those
        are undetectable by ANY decoder, the reference included; the
        survivors must decode to the same pixels as the host frontend.
        Flips that derail code structure must be DETECTED (invalid window,
        AC overflow, or bit-consumption drift -- the last is stronger
        than the reference's invalid-code-only check)."""
        data = self._restart_stream(seed=91)
        pj = parse(data)
        es = pj.entropy_start
        detected = survived = 0
        for byte_off in range(6):
            for bit in range(8):
                corrupt = bytes(
                    data[: es + byte_off]
                    + bytes([data[es + byte_off] ^ (1 << bit)])
                    + data[es + byte_off + 1:])
                try:
                    a, _ = jax_codec.decode_batch([corrupt],
                                                  transport="device")
                except ValueError:
                    detected += 1
                    continue
                survived += 1
                # parity: the host frontend accepts the same resynced
                # stream and produces the same pixels
                b, _ = jax_codec.decode_batch([corrupt],
                                              transport="ycc420")
                assert np.array_equal(a, b)
        assert detected + survived == 48
        assert detected >= 10, (detected, survived)   # 15 on this corpus


class TestIndexedTransport:
    """Index-assisted two-pass decode of restart-FREE streams (SURVEY 2.7
    option (b); DESIGN.md section 5c): serial length-only index scan +
    parallel device re-decode with skip0/preds0 injection."""

    @pytest.mark.parametrize("hw,seed", [
        ((64, 64), 1), ((48, 80), 2), ((128, 96), 3),
    ])
    def test_bitexact_vs_host_frontend(self, hw, seed):
        from imagegen import make_test_image

        img = make_test_image(*hw, seed=seed)
        data = jax_codec.encode(*split(img))       # NO restart markers
        a = np.stack(jax_codec.decode(data, transport="indexed")[:3])
        b = np.stack(jax_codec.decode(data, transport="ycc420")[:3])
        assert np.array_equal(a, b)

    def test_noise_stream(self):
        rng = np.random.default_rng(5)
        img = rng.integers(0, 256, (64, 64, 3), np.uint8)
        data = jax_codec.encode(*split(img))
        a = np.stack(jax_codec.decode(data, transport="indexed")[:3])
        b = np.stack(jax_codec.decode(data, transport="ycc420")[:3])
        assert np.array_equal(a, b)

    def test_foreign_restart_free_stream(self):
        """The reference's own output shape: a libjpeg stream with NO
        restart markers and optimized tables."""
        import io

        Image = pytest.importorskip("PIL.Image")
        from imagegen import make_test_image

        img = make_test_image(64, 80, seed=6)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85, subsampling=2,
                                  optimize=True)
        data = buf.getvalue()
        assert b"\xff\xdd" not in data
        a = np.stack(jax_codec.decode(data, transport="indexed")[:3])
        b = np.stack(jax_codec.decode(data, transport="ycc420")[:3])
        assert np.array_equal(a, b)

    def test_batch(self):
        from imagegen import make_test_image

        batch = np.stack([make_test_image(64, 64, seed=7 + i)
                          for i in range(3)])
        streams = jax_codec.encode_batch(batch)
        a, _ = jax_codec.decode_batch(streams, transport="indexed")
        b, _ = jax_codec.decode_batch(streams, transport="ycc420")
        assert np.array_equal(a, b)

    def test_rejects_restart_streams(self, small_rgb):
        data = jax_codec.encode(*split(small_rgb), restart_interval=2)
        with pytest.raises(ValueError):
            jax_codec.decode(data, transport="indexed")


class TestAutoPick:
    def test_restart_streams_default_to_device(self, small_rgb, monkeypatch):
        """transport=None on restart streams routes to the device decoder
        (identical pixels; verified by spying on the dispatch)."""
        calls = []
        orig = jax_codec._decode_batch_device_dispatch

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(jax_codec, "_decode_batch_device_dispatch", spy)
        data = jax_codec.encode(*split(small_rgb), restart_interval=2)
        auto = np.stack(jax_codec.decode(data)[:3])
        assert calls, "device dispatch not used for a restart stream"
        ref = np.stack(jax_codec.decode(data, transport="ycc420")[:3])
        assert np.array_equal(auto, ref)

    def test_auto_falls_back_when_ineligible(self, small_rgb, monkeypatch):
        """Auto mode degrades to the sparse transport if the device path
        rejects the stream (foreign table layouts etc.)."""
        def boom(*a, **k):
            raise ValueError("nonstandard")

        monkeypatch.setattr(jax_codec, "_decode_batch_device_dispatch", boom)
        data = jax_codec.encode(*split(small_rgb), restart_interval=2)
        out = np.stack(jax_codec.decode(data)[:3])          # must not raise
        ref = np.stack(jax_codec.decode(data, transport="ycc420")[:3])
        assert np.array_equal(out, ref)
        streams = [data, data]
        pix, _ = jax_codec.decode_batch(streams)            # batch path too
        assert np.array_equal(pix[0].transpose(2, 0, 1), ref)

    def test_explicit_device_on_ineligible_raises(self, small_rgb):
        data = jax_codec.encode(*split(small_rgb))          # no DRI
        with pytest.raises(ValueError):
            jax_codec.decode(data, transport="device")


class TestShardedDeviceDecode:
    """Whole-decode (Huffman included) sharded over the virtual mesh."""

    @pytest.fixture(scope="class")
    def mesh24(self):
        import jax
        from jpezy_tpu.parallel.mesh import make_mesh

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        return make_mesh(data=2, tile=4)

    def test_matches_unsharded_rgb_pixels(self, mesh24):
        from imagegen import make_test_image
        from jpezy_tpu.parallel.api import decode_sharded, encode_sharded

        batch = np.stack([make_test_image(128, 64, seed=30 + i)
                          for i in range(4)])
        streams = encode_sharded(mesh24, batch, restart_interval=2)
        pix = decode_sharded(mesh24, streams)     # device-sharded path
        for i, s in enumerate(streams):
            r, g, b, _ = jax_codec.decode(s, transport="rgb")
            assert np.array_equal(pix[i], np.stack([r, g, b], -1)), i

    def test_spied_routing(self, mesh24, monkeypatch):
        """Restart streams actually take the device-sharded path."""
        from imagegen import make_test_image
        from jpezy_tpu.parallel import api

        calls = []
        orig = api._decode_sharded_device

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(api, "_decode_sharded_device", spy)
        batch = np.stack([make_test_image(128, 64, seed=40 + i)
                          for i in range(2)])
        streams = api.encode_sharded(mesh24, batch, restart_interval=2)
        api.decode_sharded(mesh24, streams)
        assert calls

    def test_misaligned_mesh_falls_back(self, mesh24):
        """ri that leaves segments misaligned with shards degrades to the
        host-frontend path, still correct."""
        from imagegen import make_test_image
        from jpezy_tpu.parallel.api import decode_sharded

        img = make_test_image(128, 64, seed=50)
        data = jax_codec.encode(img[..., 0], img[..., 1], img[..., 2],
                                restart_interval=3)   # 3 does not divide 32
        pix = decode_sharded(mesh24, [data, data])
        r, g, b, _ = jax_codec.decode(data, transport="rgb")
        assert np.array_equal(pix[0], np.stack([r, g, b], -1))


class TestRobustness:
    def test_corrupt_entropy_terminates(self):
        """Garbage segment bytes must terminate (the bitpos bound turns
        invalid-window loops into done lanes), not hang or crash."""
        from jpezy_tpu.ops.entropy_decode import decode_segments

        rng = np.random.default_rng(3)
        words = jnp.asarray(rng.integers(0, 2**32, (8, 16), np.uint64)
                            .astype(np.uint32))
        lut = jnp.asarray(
            np.full((6, 65536), -1, np.int32))      # all windows invalid
        blocks, bad = decode_segments(
            words, jnp.full(8, 6, np.int32), lut, max_blocks=6)
        assert np.asarray(blocks).shape == (8, 6, 64)   # returned, bounded
        assert np.asarray(bad).all()                # and FLAGGED (r4 #4)

    def test_bitflipped_restart_stream_decodes_or_raises(self, small_rgb):
        """Flipping entropy bits of a restart stream must never crash or
        hang the default decode path; pixels may differ (garbage in)."""
        data = bytearray(
            jax_codec.encode(*split(small_rgb), restart_interval=2))
        pj = parse(bytes(data))
        rng = np.random.default_rng(11)
        for trial in range(4):
            corrupt = bytearray(data)
            # flip a few bits inside the entropy region, avoiding 0xFF
            # creation at random (marker corruption exercises the
            # fallback/raise path, also fine)
            for _ in range(3):
                i = rng.integers(pj.entropy_start, len(data) - 2)
                corrupt[i] ^= 1 << int(rng.integers(0, 8))
            try:
                r, g, b, _ = jax_codec.decode(bytes(corrupt))
                assert r.shape == small_rgb.shape[:2]
            except (ValueError, RuntimeError):
                pass                                 # clean refusal is fine


class TestDifferentialSweep:
    def test_random_content_random_intervals(self):
        """Differential sweep: device decoder vs host C++ frontend across
        content seeds x restart intervals x geometries (bit-exact)."""
        from imagegen import make_test_image

        rng = np.random.default_rng(123)
        for trial in range(5):
            h = int(rng.choice([32, 48, 64, 80]))
            w = int(rng.choice([32, 48, 64]))
            ri = int(rng.choice([1, 2, 3, 5, 7]))
            img = make_test_image(h, w, seed=1000 + trial)
            data = jax_codec.encode(*split(img), restart_interval=ri)
            a = np.stack(jax_codec.decode(data, transport="device")[:3])
            b = np.stack(jax_codec.decode(data, transport="ycc420")[:3])
            assert np.array_equal(a, b), (h, w, ri)
