"""Smoke test of the codec's main path on a GPU, at the sizes users run.

    python chip_smoke.py           one card: every phase below
    python chip_smoke.py --four    four cards: the sharded path only

One card drives the codec through its public entry points and checks each
result against the repo's plain references (codec/oracle.py, the float64
numpy codec, and the C++ host entropy frontend):

  encode    encode_batch, 16 x 512^2, standard and DRI=8 streams
  decode    decode_batch on the ycc420, rgb, device and indexed transports
  scan      the device Huffman scan in 'chain' and 'lut' mode, raced
  pipeline  runtime.pipeline.roundtrip_batches over 4 batches
  4k        one 4096^2 image, restart-free and DRI=8
  noise     a 2048^2 restart-free noise stream, indexed vs ycc420
  cli       jpezy_tpu.cli.main on an 8.4 MP image with --device, in process
  memory    compiled memory analysis of the fused batch encode and decode
  exact     precision="exact" encode and decode vs the oracle, byte for byte

--four runs encode_sharded / decode_sharded on a data=2 x tile=2 mesh (the
16 x 512^2 DRI=8 batch) and a data=1 x tile=4 mesh (one 4096^2 image,
restart-free, so the DC-carry ppermute runs), and compares both with the
single-card results on card 0.

The script exits non-zero, printing no result line, when JAX finds no GPU
or any check fails.  Its last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Everything runs in this one process: a second JAX process could not get
the card's memory.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_REPO, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from imagegen import make_test_image  # noqa: E402
from jpezy_tpu import cli  # noqa: E402
from jpezy_tpu.bitstream.reader import parse  # noqa: E402
from jpezy_tpu.codec import jax_codec, oracle  # noqa: E402
from jpezy_tpu.ops import entropy_decode as ED  # noqa: E402
from jpezy_tpu.runtime import native, pipeline, ppm  # noqa: E402
from jpezy_tpu.utils import compile_cache  # noqa: E402
from jpezy_tpu.utils.profiling import card_lines  # noqa: E402

PRECISION_NOTE = ("precision: fast path float32 with matmul "
                  "precision=HIGHEST; exact path float64")


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


class Report:
    """Prints each phase's results, with times labelled by the card."""

    def __init__(self, card: str):
        self.card = card

    def line(self, phase: str, msg: str) -> None:
        print(f"[{phase}] {msg}", flush=True)

    def time(self, phase: str, what: str, seconds: float) -> None:
        self.line(phase, f"{what}: {seconds * 1e3:.2f} ms [{self.card}]")


def timed(fn, reps: int = 3):
    """(result, first-call seconds, median seconds of `reps` more calls).
    fn must return host data or call block_until_ready itself."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return out, first, statistics.median(ts)


def images(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    return np.stack([make_test_image(h, w, seed=seed + i) for i in range(n)])


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def oracle_pixels(stream: bytes) -> np.ndarray:
    r, g, b, _ = oracle.decode(stream)
    return np.stack([r, g, b], -1)


def host_coeffs(stream: bytes) -> list[np.ndarray]:
    """The C++ host frontend's per-component [B, 64] coefficient blocks."""
    pj = parse(stream)
    nmcu = -(-pj.props.width // 16) * -(-pj.props.height // 16)
    return native.entropy_decode(pj, nmcu)


def check_stream(phase: str, img: np.ndarray, stream: bytes,
                 fast_pixels: np.ndarray) -> tuple[float, float]:
    """The oracle opens the stream; the stream's coefficients are within
    +-1 of the oracle's exact ones; the fast decode passes the PSNR gate
    (fast >= exact - 0.1 dB).  Returns (psnr fast, psnr exact)."""
    ref = oracle_pixels(stream)
    want = oracle.quantized_blocks(img[..., 0], img[..., 1], img[..., 2])
    for c, (got, exp) in enumerate(zip(host_coeffs(stream), want)):
        d = np.abs(got.astype(np.int64) - exp.astype(np.int64)).max()
        check(d <= 1, f"{phase}: component {c} coefficients differ from "
                      f"the exact encode by {d} (> 1)")
    p_fast, p_exact = psnr(fast_pixels, img), psnr(ref, img)
    check(p_fast >= p_exact - 0.1,
          f"{phase}: PSNR gate failed, fast {p_fast:.3f} dB < exact "
          f"{p_exact:.3f} dB - 0.1")
    return p_fast, p_exact


def check_transport_envelope(phase: str, got: np.ndarray, rgb: np.ndarray,
                             ref: np.ndarray) -> tuple[int, float]:
    """The rgb transport within the fast path's envelope of the oracle;
    the clamp-before-color transports within theirs of the rgb transport.

    Fast path: float32 truncation ties put ~11% of pixels 1 LSB off the
    oracle, and a chroma sample off by one moves B by 1.77, so a few
    pixels in 10^5 land 2 LSB off (measured on the CPU and the H100).
    Clamp-before-color: at most 64 LSB on under 6% of pixels
    (tests/test_jax_codec.py::TestYcc420ClampEnvelope).
    Returns (max LSB off the oracle, share of pixels off by more than 1)."""
    d_rgb = np.abs(rgb.astype(np.int64) - ref.astype(np.int64))
    off2 = float((d_rgb > 1).mean())
    check(d_rgb.max() <= 2 and off2 < 1e-4,
          f"{phase}: rgb transport off the oracle by up to "
          f"{d_rgb.max()} LSB, {off2:.2e} of pixels by more than 1")
    d = np.abs(got.astype(np.int64) - rgb.astype(np.int64))
    check(d.max() <= 64 and (d > 0).mean() < 0.06,
          f"{phase}: clamp envelope vs rgb transport: max {d.max()}, "
          f"{(d > 0).mean():.4f} of pixels differ")
    return int(d_rgb.max()), off2


# --------------------------------------------------------------------------
# one-card phases
# --------------------------------------------------------------------------


def phase_encode(rep: Report, imgs: np.ndarray, ri: int):
    """Batched encode, standard and restart streams; every stream checked
    against the oracle (decoded here on the reference rgb transport)."""
    n, h, w = imgs.shape[:3]
    out = {}
    for name, kw in (("standard", {}), (f"DRI={ri}", {"restart_interval": ri})):
        streams, first, t = timed(lambda: jax_codec.encode_batch(imgs, **kw))
        rep.time("encode", f"{n}x{h}x{w} {name} (first call {first:.1f} s)", t)
        pix, _ = jax_codec.decode_batch(streams, transport="rgb")
        gates = [check_stream(f"encode {name} image {i}", imgs[i], s, pix[i])
                 for i, s in enumerate(streams)]
        rep.line("encode", f"{name}: {sum(map(len, streams))} bytes; oracle "
                 f"opens all {n}; coefficients within +-1 of exact; PSNR "
                 f"fast {min(g[0] for g in gates):.3f} >= exact "
                 f"{min(g[1] for g in gates):.3f} - 0.1 dB (worst image)")
        out[name] = streams
    return out["standard"], out[f"DRI={ri}"]


def phase_decode(rep: Report, imgs: np.ndarray, streams, streams_ri):
    """decode_batch on every transport; pixels against the oracle."""
    n = len(streams)
    res = {}
    for key, tr, ss in (("rgb", "rgb", streams),
                        ("ycc420", "ycc420", streams),
                        ("indexed", "indexed", streams),
                        ("device", "device", streams_ri),
                        ("rgb DRI", "rgb", streams_ri)):
        (pix, _), first, t = timed(
            lambda: jax_codec.decode_batch(ss, transport=tr))
        rep.time("decode", f"{n} images, transport {key} "
                 f"(first call {first:.1f} s)", t)
        res[key] = pix
    check(np.array_equal(res["ycc420"], res["indexed"]),
          "decode: indexed pixels != ycc420 pixels")
    env = []
    for i in range(n):
        for key, rgb, ss in (("ycc420", "rgb", streams),
                             ("device", "rgb DRI", streams_ri)):
            ref = oracle_pixels(ss[i])
            env.append(check_transport_envelope(
                f"decode {key} image {i}", res[key][i], res[rgb][i], ref))
            p_fast, p_exact = psnr(res[key][i], imgs[i]), psnr(ref, imgs[i])
            check(p_fast >= p_exact - 0.1,
                  f"decode {key} image {i}: PSNR {p_fast:.3f} < "
                  f"{p_exact:.3f} - 0.1")
    rep.line("decode", f"rgb transport at most {max(e[0] for e in env)} "
             f"LSB off the oracle, at most {max(e[1] for e in env):.2e} of "
             "an image's pixels by more than 1; ycc420, indexed and device "
             "within the clamp envelope; PSNR gate passes on every "
             "transport; host-frontend transports decode coefficients with "
             "the C++ frontend itself, the device scan is checked against it "
             "in the scan phase")


def _scan_inputs(streams, ri: int):
    """Device-scan lanes of a batch: DRI segments (ri > 0) or the indexed
    pseudo-segments of restart-free streams (ri == 0, k = 8 MCUs)."""
    pjs = [parse(s) for s in streams]
    p0 = pjs[0]
    nmcu = -(-p0.props.width // 16) * -(-p0.props.height // 16)
    keys = {ED.lut_content_key(pj.huff, pj.scan_components) for pj in pjs}
    check(len(keys) == 1, "scan: batch mixes Huffman tables")
    if ri:
        nseg = -(-nmcu // ri)
        words, nblk, rawlen = jax_codec._device_host_frontend(
            pjs, nmcu, ri, nseg)
        skip0 = preds0 = None
        k = ri
    else:
        k = 8
        nseg = -(-nmcu // k)
        words, nblk, skip0, preds0 = jax_codec._indexed_host_frontend(
            pjs, nmcu, k)
        rawlen = None
    dev = [None if a is None else jnp.asarray(a)
           for a in (words, nblk, rawlen, skip0, preds0)]
    return pjs, p0, nmcu, nseg, k, dev


def _scan_tables(mode: str, p0):
    build = (ED.build_decode_chain_tables if mode == "chain"
             else ED.build_decode_lut)
    return jnp.asarray(build(p0.huff, p0.scan_components))


def phase_scan(rep: Report, streams_ri, streams, ri: int) -> str:
    """Both scan modes on the DRI lanes and the indexed lanes: bit-exact
    against each other and the C++ host frontend.  Returns the faster mode
    on the DRI lanes."""
    times = {}
    for lanes, ss, r in (("DRI", streams_ri, ri), ("indexed", streams, 0)):
        pjs, p0, nmcu, nseg, k, (words, nblk, rawlen, skip0, preds0) = \
            _scan_inputs(ss, r)
        host = [host_coeffs(s) for s in ss]
        N = len(ss)
        for mode in ("chain", "lut"):
            tabs = _scan_tables(mode, p0)
            run = lambda: jax.block_until_ready(ED.decode_segments(  # noqa
                words, nblk, tabs, None, rawlen, skip0, preds0,
                max_blocks=k * 6))
            (blocks, bad), first, t = timed(run, reps=5)
            times[(lanes, mode)] = t
            rep.time("scan", f"{mode} on {N * nseg} {lanes} lanes "
                     f"(first call {first:.1f} s)", t)
            check(not np.asarray(bad).any(), f"scan {mode}: bad flags set")
            b6 = np.asarray(blocks).reshape(N, nseg * k, 6, 64)[:, :nmcu]
            for i in range(N):
                dev = (b6[i, :, :4].reshape(nmcu * 4, 64), b6[i, :, 4],
                       b6[i, :, 5])
                for c in range(3):
                    check(np.array_equal(dev[c], host[i][c]),
                          f"scan {mode} {lanes}: image {i} component {c} "
                          "differs from the host frontend")
    rep.line("scan", "chain and lut bit-exact against each other and the "
             "C++ host frontend on DRI and indexed lanes")
    fast = min(("chain", "lut"), key=lambda m: times[("DRI", m)])
    rep.line("scan", f"faster mode on this card: {fast}; "
             f"scan_mode() default here: {ED.scan_mode()}")
    return fast


def phase_pipeline(rep: Report, batches, ri: int) -> None:
    """roundtrip_batches(lookahead=2, DRI, device transport) against the
    serial encode_batch -> decode_batch of the same batches."""
    kw = dict(lookahead=2, restart_interval=ri, transport="device")
    out, first, t = timed(
        lambda: list(pipeline.roundtrip_batches(iter(batches), **kw)), reps=2)
    n_img = sum(len(b) for b in batches)
    rep.time("pipeline", f"{len(batches)} batches, {n_img} images "
             f"(first call {first:.1f} s)", t)
    for j, (b, (s_pipe, pix_pipe)) in enumerate(zip(batches, out)):
        s_ser = jax_codec.encode_batch(b, restart_interval=ri)
        pix_ser, _ = jax_codec.decode_batch(s_ser, transport="device")
        check(s_pipe == s_ser, f"pipeline batch {j}: streams != serial")
        check(np.array_equal(pix_pipe, pix_ser),
              f"pipeline batch {j}: pixels != serial")
    rep.line("pipeline", "streams and pixels equal the serial path")


def phase_single(rep: Report, img: np.ndarray, ri: int) -> None:
    """One large image through the batch entry points at N = 1."""
    h, w = img.shape[:2]
    for name, kw, tr in (("restart-free", {}, "ycc420"),
                         (f"DRI={ri}", {"restart_interval": ri}, "device")):
        streams, first, t = timed(
            lambda: jax_codec.encode_batch(img[None], **kw))
        rep.time("single", f"{h}x{w} {name} encode (first call {first:.1f}"
                 " s)", t)
        (pix, _), first, t = timed(lambda: jax_codec.decode_batch(streams))
        rep.time("single", f"{h}x{w} {name} decode, auto transport {tr} "
                 f"(first call {first:.1f} s)", t)
        rgb, _ = jax_codec.decode_batch(streams, transport="rgb")
        ref = oracle_pixels(streams[0])
        mx, off2 = check_transport_envelope(f"single {name}", pix[0],
                                            rgb[0], ref)
        p_fast, p_exact = check_stream(f"single {name}", img, streams[0],
                                       pix[0])
        rep.line("single", f"{name}: {len(streams[0])} bytes; rgb transport "
                 f"at most {mx} LSB off the oracle ({off2:.2e} of pixels by "
                 f"more than 1); PSNR fast {p_fast:.3f} >= exact "
                 f"{p_exact:.3f} - 0.1 dB")


def phase_noise(rep: Report, noise: np.ndarray) -> None:
    """A dense restart-free stream: indexed and ycc420 decodes agree."""
    h, w = noise.shape[:2]
    data = jax_codec.encode(noise[..., 0], noise[..., 1], noise[..., 2])
    res = {}
    for tr in ("indexed", "ycc420"):
        out, first, t = timed(lambda: np.stack(
            jax_codec.decode(data, transport=tr)[:3], -1))
        rep.time("noise", f"{h}x{w} restart-free ({len(data)} bytes), "
                 f"decode {tr} (first call {first:.1f} s)", t)
        res[tr] = out
    check(np.array_equal(res["indexed"], res["ycc420"]),
          "noise: indexed pixels != ycc420 pixels")
    rep.line("noise", "indexed == ycc420, pixel for pixel")


def phase_cli(rep: Report, img: np.ndarray, workdir: str) -> None:
    """The CLI in this process with the accelerator forced; its bytes and
    pixels equal the library's."""
    h, w = img.shape[:2]
    src = os.path.join(workdir, "in.ppm")
    jpg = os.path.join(workdir, "out.jpg")
    dec = os.path.join(workdir, "dec.ppm")
    ppm.write(src, img, fmt="P6")
    t0 = time.perf_counter()
    rc = cli.main(["encode", src, jpg, "--device"])
    t_enc = time.perf_counter() - t0
    check(rc == 0, f"cli encode exited {rc}")
    with open(jpg, "rb") as f:
        data = f.read()
    check(data == jax_codec.encode(img[..., 0], img[..., 1], img[..., 2]),
          "cli: encoded bytes != library encode")
    t0 = time.perf_counter()
    rc = cli.main(["decode", jpg, dec, "--device"])
    t_dec = time.perf_counter() - t0
    check(rc == 0, f"cli decode exited {rc}")
    _, _, _, got = ppm.read(dec)
    want = np.stack(jax_codec.decode(data)[:3], -1)
    check(np.array_equal(got, want), "cli: decoded pixels != library decode")
    rep.time("cli", f"encode {h}x{w} ({h * w / 1e6:.1f} MP) incl. PPM read "
             "and first compile", t_enc)
    rep.time("cli", "decode incl. P3 write and first compile", t_dec)
    rep.line("cli", "bytes and pixels equal the library's")


def _fmt_mib(nbytes) -> str:
    return f"{nbytes / 2**20:.1f} MiB"


def phase_memory(rep: Report, imgs: np.ndarray, streams_ri, ri: int) -> None:
    """memory_analysis() of the fused batch encode and device decode as
    compiled for this device, and the peak bytes in use so far."""
    n, h, w = imgs.shape[:3]
    y, cb, cr = jax_codec.host_rgb_to_ycc420(imgs)
    packed = jnp.asarray(np.concatenate(
        [y.reshape(n, -1), cb.reshape(n, -1), cr.reshape(n, -1)], axis=1))
    enc = jax_codec._encode_batch_blocks_packed.lower(
        packed, h=h, w=w, restart_interval=ri).compile()
    pjs, p0, nmcu, nseg, k, (words, nblk, rawlen, _, _) = \
        _scan_inputs(streams_ri, ri)
    lut, tsel = jax_codec._device_luts(pjs, nseg)
    my, mx = -(-h // 16), -(-w // 16)
    geom = ((my, mx, 2, 2, 1, 1), (my, mx, 1, 1, 2, 2), (my, mx, 1, 1, 2, 2))
    dec = jax_codec._decode_fused_batch_device.lower(
        words, nblk, jnp.asarray(lut), jnp.asarray(tsel), rawlen,
        jnp.asarray(jax_codec._quant_arr(pjs)),
        N=n, nseg=nseg, ri=k, geom=geom, level=128).compile()
    for name, c in (("fused encode", enc), ("fused device decode", dec)):
        ma = c.memory_analysis()
        rep.line("memory", f"{name} {n}x{h}x{w}: " + (
            "memory_analysis unavailable" if ma is None else
            f"arguments {_fmt_mib(ma.argument_size_in_bytes)}, outputs "
            f"{_fmt_mib(ma.output_size_in_bytes)}, temporaries "
            f"{_fmt_mib(ma.temp_size_in_bytes)}, code "
            f"{_fmt_mib(ma.generated_code_size_in_bytes)}"))
    stats = jax.devices()[0].memory_stats()
    rep.line("memory", "peak_bytes_in_use: " + (
        "not reported by this backend" if not stats else
        _fmt_mib(stats.get("peak_bytes_in_use", 0))))


def phase_exact(rep: Report, img: np.ndarray, ri: int) -> None:
    """precision="exact" is byte- and pixel-identical to the oracle.
    Needs jax_enable_x64."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    h, w = r.shape
    for name, kw in (("standard", {}), (f"DRI={ri}", {"restart_interval": ri})):
        want = oracle.encode(r, g, b, **kw)
        got, first, t = timed(
            lambda: jax_codec.encode(r, g, b, precision="exact", **kw))
        rep.time("exact", f"encode {h}x{w} {name} (first call {first:.1f} "
                 "s)", t)
        check(got == want, f"exact {name}: stream != oracle.encode")
        got_rgb = jax_codec.encode_batch(
            img[None], precision="exact", transport="rgb", **kw)[0]
        check(got_rgb == want,
              f"exact {name}: rgb-transport stream != oracle.encode")
        pix, first, t = timed(lambda: np.stack(
            jax_codec.decode(want, precision="exact")[:3], -1))
        rep.time("exact", f"decode {h}x{w} {name} (first call {first:.1f} "
                 "s)", t)
        check(np.array_equal(pix, oracle_pixels(want)),
              f"exact {name}: decoded pixels != oracle.decode")
    rep.line("exact", "streams byte-identical to oracle.encode (ycc420 and "
             "rgb transports); decode pixel-identical to oracle.decode")


# --------------------------------------------------------------------------
# four-card phase
# --------------------------------------------------------------------------


def phase_four(rep: Report, devices, imgs: np.ndarray, big: np.ndarray,
               ri: int) -> None:
    """encode_sharded / decode_sharded on four devices against the
    single-device results on devices[0], byte for byte and pixel for
    pixel.  The sharded encode converts color on the device, so its
    single-device counterpart is the rgb transport."""
    from jpezy_tpu.parallel.api import decode_sharded, encode_sharded
    from jpezy_tpu.parallel.mesh import make_mesh

    cases = (("data=2 x tile=2", make_mesh(data=2, tile=2, devices=devices),
              imgs, ri),
             ("data=1 x tile=4", make_mesh(data=1, tile=4, devices=devices),
              big[None], 0),
             ("data=1 x tile=4", make_mesh(data=1, tile=4, devices=devices),
              big[None], ri))
    for name, mesh, batch, r in cases:
        n, h, w = batch.shape[:3]
        what = f"{name}, {n}x{h}x{w}, " + (f"DRI={r}" if r else "restart-free")
        streams, first, t = timed(
            lambda: encode_sharded(mesh, batch, restart_interval=r))
        rep.time("four", f"encode_sharded {what} (first call {first:.1f} s)",
                 t)
        with jax.default_device(devices[0]):
            want = jax_codec.encode_batch(batch, transport="rgb",
                                          restart_interval=r)
            want_pix, _ = jax_codec.decode_batch(want, transport="rgb")
        check(streams == want, f"four {what}: sharded streams != card 0")
        pix, first, t = timed(lambda: decode_sharded(mesh, streams))
        rep.time("four", f"decode_sharded {what} (first call {first:.1f} s)",
                 t)
        check(np.array_equal(pix, want_pix),
              f"four {what}: sharded pixels != card 0")
        rep.line("four", f"{what}: streams and pixels equal card 0's")


# --------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs; JAX found {len(devices)}",
              file=sys.stderr)
        return 1
    cards = card_lines()
    for ln in cards:
        print(f"card: {ln}", flush=True)
    kind = devices[0].device_kind
    print(f"device_kind: {kind}; JAX {jax.__version__}; {len(devices)} "
          "device(s)", flush=True)
    print(PRECISION_NOTE, flush=True)
    compile_cache.enable()
    rep = Report(cards[0])
    ri = 8
    t0 = time.perf_counter()

    imgs = images(16, 512, 512)
    big = make_test_image(4096, 4096, seed=40)
    if args.four:
        phase_four(rep, devices[:4], imgs, big, ri)
    else:
        streams, streams_ri = phase_encode(rep, imgs, ri)
        phase_decode(rep, imgs, streams, streams_ri)
        phase_scan(rep, streams_ri, streams, ri)
        phase_pipeline(rep, [images(16, 512, 512, seed=100 + 16 * j)
                             for j in range(4)], ri)
        phase_single(rep, big, ri)
        noise = np.random.default_rng(99).integers(
            0, 256, (2048, 2048, 3), np.uint8)
        phase_noise(rep, noise)
        with tempfile.TemporaryDirectory() as d:
            phase_cli(rep, make_test_image(2048, 4096, seed=50), d)
        phase_memory(rep, imgs, streams_ri, ri)
        jax.config.update("jax_enable_x64", True)
        phase_exact(rep, imgs[0], ri)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s "
          f"[{rep.card}]", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
