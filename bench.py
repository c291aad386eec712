"""Benchmark: encode+decode 512x512 round-trip throughput on one GPU.

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": "MP/s", "vs_baseline": N, ...}

Baseline (BASELINE.md): the reference encodes a 512x512 image in 0.042 s and
decodes in 0.055 s single-threaded (core time, excluding its 0.522 s PPM
parse), i.e. a round-trip of 0.097 s -> 2.70 MP/s.  vs_baseline is our
sustained round-trip MP/s divided by 2.70.

It runs on the GPU JAX finds and fails when there is none: a CPU number is
never reported under a device metric.  Device-only times bracket K
back-to-back executions with block_until_ready.  Every line of output
names the card and its power limit.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))

REF_ROUNDTRIP_MPS = (512 * 512 / 1e6) / (0.042 + 0.055)  # 2.70 MP/s


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_time(fn, K=8):
    """Seconds per call of fn, best of 3 loops of K back-to-back calls
    that end in block_until_ready."""
    import jax

    loops = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(K):
            out = fn()
        jax.block_until_ready(out)
        loops.append(time.perf_counter() - t0)
    return min(loops) / K


def measure(card: str) -> dict:
    import jax

    from imagegen import make_test_image
    from jpezy_tpu.codec import jax_codec
    from jpezy_tpu.utils import compile_cache

    compile_cache.enable()
    cdir = jax.config.jax_compilation_cache_dir or os.environ.get(
        "JAX_COMPILATION_CACHE_DIR")
    n_cached = len(os.listdir(cdir)) if cdir and os.path.isdir(cdir) else 0
    log(f"compile cache: {cdir} ({n_cached} entries)")
    log(f"devices: {jax.devices()} [{card}]")

    h = w = 512
    mp = h * w / 1e6
    batch_n = 16
    batches = [
        np.stack([make_test_image(h, w, seed=j * batch_n + i)
                  for i in range(batch_n)])
        for j in range(2)
    ]

    # ---- single image (reference-comparable latency)
    img = batches[0][0]
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    t0 = time.time()
    data = jax_codec.encode(r, g, b)
    log(f"first encode (compile): {time.time()-t0:.1f}s, {len(data)} bytes")
    t0 = time.time()
    jax_codec.decode(data)
    log(f"first decode (compile): {time.time()-t0:.1f}s")

    ts = []
    for i in range(5):
        im = batches[0][i % batch_n]
        t0 = time.time()
        jax_codec.encode(im[..., 0], im[..., 1], im[..., 2])
        ts.append(time.time() - t0)
    t_enc1 = min(ts)
    ts = []
    for _ in range(5):
        t0 = time.time()
        jax_codec.decode(data)
        ts.append(time.time() - t0)
    t_dec1 = min(ts)
    log(f"single encode: {t_enc1*1000:.1f}ms ({mp/t_enc1:.1f} MP/s)")
    log(f"single decode: {t_dec1*1000:.1f}ms ({mp/t_dec1:.1f} MP/s)")
    # the PRODUCTION single-small-image path is the host C++ codec
    # (codec/host_codec.py; the CLI auto-picks it below 8 MP): measure it
    # too -- the policy's chosen backend is the honest N=1 number
    try:
        from jpezy_tpu.codec import host_codec as _hc

        _hc.encode(r, g, b)                       # warm (lazy .so build)
        _hc.decode(data)
        ts = []
        for i in range(5):
            im = batches[0][i % batch_n]
            t0 = time.time()
            _hc.encode(im[..., 0], im[..., 1], im[..., 2])
            ts.append(time.time() - t0)
        t_enc_h = min(ts)
        ts = []
        for _ in range(5):
            t0 = time.time()
            _hc.decode(data)
            ts.append(time.time() - t0)
        t_dec_h = min(ts)
        log(f"single encode/decode [host C++ codec]: {t_enc_h*1e3:.1f} / "
            f"{t_dec_h*1e3:.1f}ms")
    except ImportError:
        t_enc_h = t_dec_h = float("inf")
    # reference core encode 42 ms + decode 55 ms = 97 ms (README.md:52,76);
    # the single-image path must beat the reference at N=1
    t_single_dev = t_enc1 + t_dec1
    t_single_rt = min(t_single_dev, t_enc_h + t_dec_h)
    log(f"single round-trip (auto backend policy): {t_single_rt*1e3:.1f}ms "
        f"(device path {t_single_dev*1e3:.1f}; reference core: 97ms; "
        f"{'BEATS' if t_single_rt < 0.097 else 'LOSES TO'} the reference)")

    # ---- comparative quality gates: the fast
    # path must match the exact/oracle path's PSNR on the same stream, not
    # just an absolute floor.  oracle.decode pins the reference's double-
    # precision decode semantics bit-for-bit.
    from jpezy_tpu.codec import oracle as _oracle

    rf, gf, bf, _ = jax_codec.decode(data)              # fast default path
    ro, go, bo, _ = _oracle.decode(data)                # reference-exact
    src = img.astype(np.float64)
    fast = np.stack([rf, gf, bf], -1).astype(np.float64)
    exact = np.stack([ro, go, bo], -1).astype(np.float64)
    psnr_fast = 10 * np.log10(255**2 / np.mean((fast - src) ** 2))
    psnr_exact = 10 * np.log10(255**2 / np.mean((exact - src) ** 2))
    log(f"decode quality: fast path {psnr_fast:.3f} dB vs reference-exact "
        f"{psnr_exact:.3f} dB (gate: fast >= exact - 0.1)")
    assert psnr_fast >= psnr_exact - 0.1, \
        f"fast-path PSNR regressed: {psnr_fast:.3f} < {psnr_exact:.3f} - 0.1"

    # ---- batched pipeline (production path, one fetch per batch).
    # Decode is measured on every transport and the faster
    # one feeds the pipelined round-trip below.
    streams = jax_codec.encode_batch(batches[0])   # compile
    t_tr = {}
    for tr in ("ycc420", "indexed", "rgb"):
        try:
            jax_codec.decode_batch(streams, transport=tr)   # compile
        except (ImportError, ValueError) as e:
            log(f"batched decode [{tr}] unavailable: {e}")
            continue
        ts = []
        for trial in range(3):
            t0 = time.time()
            jax_codec.decode_batch(streams, transport=tr)
            ts.append(time.time() - t0)
        t_tr[tr] = min(ts)
        log(f"batched decode x{batch_n} [{tr}]: {t_tr[tr]*1000:.0f}ms "
            f"({batch_n*mp/t_tr[tr]:.1f} MP/s)")
    transport = min(t_tr, key=t_tr.get)
    log(f"decode transport measured-pick: {transport}")
    t_enc = []
    for trial in range(3):
        imgs = batches[trial % 2]
        t0 = time.time()
        streams = jax_codec.encode_batch(imgs)
        t_enc.append(time.time() - t0)
    t_benc, t_bdec = min(t_enc), t_tr[transport]
    log(f"batched encode x{batch_n}: {t_benc*1000:.0f}ms "
        f"({batch_n*mp/t_benc:.1f} MP/s)")
    v_serial = batch_n * mp / (t_benc + t_bdec)
    log(f"round-trip (batched, serial): {v_serial:.2f} MP/s")

    metric_name = (
        "encode+decode 512x512 round-trip throughput "
        f"(pipelined batches of {batch_n}, {card})"
    )

    # ---- restart-interval streams + DEVICE entropy decode: our own production streams carry DRI so the WHOLE decode
    # (including the Huffman frontend) can run on device -- raw entropy
    # bytes up (~0.07 B/px) instead of sparse coefficients (~0.6 B/px).
    RI = 8                                  # 8 MCUs/segment: 128 seg/image
    streams_ri = jax_codec.encode_batch(batches[0], restart_interval=RI)
    log(f"restart streams (DRI={RI}): {sum(map(len, streams_ri))} bytes "
        f"vs {sum(map(len, streams))} restart-free "
        f"(+{(sum(map(len, streams_ri))/sum(map(len, streams))-1)*100:.1f}%)")
    t_ri = {}
    for tr in ("device", "ycc420"):
        jax_codec.decode_batch(streams_ri, transport=tr)    # compile
        ts = []
        for _ in range(3):
            t0 = time.time()
            out_ri, _ = jax_codec.decode_batch(streams_ri, transport=tr)
            ts.append(time.time() - t0)
        t_ri[tr] = min(ts)
        log(f"batched decode x{batch_n} restart streams [{tr}]: "
            f"{t_ri[tr]*1e3:.0f}ms ({batch_n*mp/t_ri[tr]:.1f} MP/s)")
    tr_ri = min(t_ri, key=t_ri.get)
    ts = []
    for _ in range(3):
        t0 = time.time()
        streams_ri = jax_codec.encode_batch(batches[0], restart_interval=RI)
        ts.append(time.time() - t0)
    t_benc_ri = min(ts)
    v_serial_ri = batch_n * mp / (t_benc_ri + t_ri[tr_ri])
    log(f"round-trip (restart streams, serial, decode={tr_ri}): "
        f"{v_serial_ri:.2f} MP/s")

    # ---- stage attribution + device-only throughput: split one batch
    # encode into host color / upload / device / fetch.
    from jpezy_tpu.codec.jax_codec import (
        host_rgb_to_ycc420, _encode_batch_blocks_ycc)
    import jax.numpy as jnp

    imgs0 = batches[0]
    t0 = time.time(); y, cb, cr = host_rgb_to_ycc420(imgs0)
    t_color = time.time() - t0
    t0 = time.time()
    dev = jax.block_until_ready(
        (jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr)))
    t_up = time.time() - t0
    out0 = _encode_batch_blocks_ycc(*dev)
    jax.block_until_ready(out0)                         # compile/warm
    t_dev = device_time(lambda: _encode_batch_blocks_ycc(*dev))
    t0 = time.time(); _ = np.asarray(out0[0]); t_fetch = time.time() - t0
    log(f"encode attribution x{batch_n}: host color {t_color*1e3:.0f}ms, "
        f"upload {t_up*1e3:.0f}ms ({(y.nbytes+cb.nbytes+cr.nbytes)/2**20:.1f}"
        f" MiB), device {t_dev*1e3:.2f}ms/batch ("
        f"{batch_n*mp/t_dev:.0f} MP/s device-only), "
        f"fetch {t_fetch*1e3:.0f}ms ({np.asarray(out0[0]).nbytes/2**20:.1f} MiB)")

    # ---- decode attribution + device-only decode throughput: mirror the
    # encode attribution for BOTH decode backends.
    from jpezy_tpu.bitstream.reader import parse as _parse
    from jpezy_tpu.codec.jax_codec import (
        _decode_fused_batch_device, _decode_fused_batch_ycc420,
        _device_host_frontend, _ycc420_host_frontend)
    from jpezy_tpu.core.geometry import ComponentGeometry

    def _geom_meta(p0):
        geos = [ComponentGeometry(fc.H, fc.V, p0.hmax, p0.vmax,
                                  p0.props.width, p0.props.height)
                for fc in p0.frame_components]
        geom = tuple((geos[0].mcus_y, geos[0].mcus_x, fc.V, fc.H,
                      geos[i].dup_y, geos[i].dup_x)
                     for i, fc in enumerate(p0.frame_components))
        qt = tuple(tuple(int(x) for x in p0.quant[fc.Tq])
                   for fc in p0.frame_components)
        return geos, geom, qt

    # (a) ycc420 sparse transport on the standard streams
    pjs = [_parse(s) for s in streams]
    t0 = time.time()
    flat_host, shapes, caps = _ycc420_host_frontend(pjs)
    t_front = time.time() - t0
    _, geom, qtuple = _geom_meta(pjs[0])
    t0 = time.time()
    flat_dev = jax.block_until_ready(jnp.asarray(flat_host))
    t_up_d = time.time() - t0
    run = lambda: _decode_fused_batch_ycc420(
        flat_dev, geom=geom, level=128, shapes=shapes, K=10,
        N=batch_n, caps=caps, qtuple=qtuple)
    out_d = run(); jax.block_until_ready(out_d)         # compile/warm
    t_dev_d = device_time(run)
    t0 = time.time(); packed_host = np.asarray(out_d)
    t_fetch_d = time.time() - t0
    from jpezy_tpu.codec.jax_codec import _decode_batch_ycc420_finish
    t0 = time.time()
    _decode_batch_ycc420_finish(("ycc420", packed_host, pjs[0].props,
                                 batch_n, geom[0][1], geom[0][0]))
    t_tail = time.time() - t0
    log(f"decode attribution x{batch_n} [ycc420]: host frontend "
        f"{t_front*1e3:.0f}ms, upload {t_up_d*1e3:.0f}ms "
        f"({flat_host.nbytes/2**20:.2f} MiB), device {t_dev_d*1e3:.2f}ms"
        f"/batch ({batch_n*mp/t_dev_d:.0f} MP/s device-only), fetch "
        f"{t_fetch_d*1e3:.0f}ms ({packed_host.nbytes/2**20:.1f} MiB), host "
        f"color tail {t_tail*1e3:.0f}ms")
    dec_attr = {"front_ms": round(t_front * 1e3, 1),
                "device_ms": round(t_dev_d * 1e3, 2),
                "device_mps": round(batch_n * mp / t_dev_d, 1)}

    # (b) device transport on the restart streams (Huffman ON device)
    pjs_ri = [_parse(s) for s in streams_ri]
    nmcu = geom[0][0] * geom[0][1]
    nseg = -(-nmcu // RI)
    t0 = time.time()
    words_h, nblk_h, rawlen_h = _device_host_frontend(pjs_ri, nmcu, RI, nseg)
    t_front_ri = time.time() - t0
    t0 = time.time()
    words_dev = jax.block_until_ready(jnp.asarray(words_h))
    nblk_dev = jax.block_until_ready(jnp.asarray(nblk_h))
    rawlen_dev = jax.block_until_ready(jnp.asarray(rawlen_h))
    tsel_dev = jax.block_until_ready(
        jnp.zeros(words_h.shape[0], jnp.int32))
    t_up_ri = time.time() - t0
    from jpezy_tpu.ops.entropy_decode import build_scan_tables, device_lut
    lut_dev = device_lut(build_scan_tables(pjs_ri[0].huff))
    qarr_dev = jax.block_until_ready(jnp.asarray(np.stack([
        np.stack([np.asarray(pj.quant[fc.Tq], np.int32)
                  for fc in pj.frame_components]) for pj in pjs_ri])))
    run_ri = lambda: _decode_fused_batch_device(
        words_dev, nblk_dev, lut_dev, tsel_dev, rawlen_dev, qarr_dev,
        N=batch_n, nseg=nseg, ri=RI, geom=geom, level=128)
    out_ri2 = run_ri(); jax.block_until_ready(out_ri2)
    t_dev_ri = device_time(run_ri)
    t0 = time.time(); _ = np.asarray(out_ri2); t_fetch_ri = time.time() - t0
    log(f"decode attribution x{batch_n} [device, DRI={RI}]: host destuff "
        f"{t_front_ri*1e3:.0f}ms, upload {t_up_ri*1e3:.0f}ms "
        f"({words_h.nbytes/2**20:.2f} MiB entropy bytes), device (incl "
        f"Huffman) {t_dev_ri*1e3:.1f}ms/batch ({batch_n*mp/t_dev_ri:.0f} "
        f"MP/s device-only), fetch {t_fetch_ri*1e3:.0f}ms")
    dec_attr["device_transport_ms"] = round(t_dev_ri * 1e3, 2)
    dec_attr["device_transport_upload_mib"] = round(
        words_h.nbytes / 2**20, 2)

    # ---- device STAGE attribution: block_until_ready-bracketed device
    # time per encode stage (quantize / emissions+interleave / pack /
    # concat) and for the decode Huffman scan alone, at the batch shape.
    # Stages re-run standalone, so their sum can exceed the fused total
    # (XLA fuses across stage boundaries); the deltas still rank them.
    import functools as _ft

    from jpezy_tpu.ops import entropy as E_ops
    from jpezy_tpu.ops.entropy_decode import decode_segments as _dseg
    from jpezy_tpu.parallel import sharded as SH

    quant_fn = jax.jit(_ft.partial(
        SH._quantize_local_ycc, gray=False, dtype=jnp.float32,
        rounded=False, qtables=None))
    q3 = quant_fn(*dev)
    jax.block_until_ready(q3)
    t_quant = device_time(lambda: quant_fn(*dev))

    def _emit_interleave(yq, cbq, crq):
        ems = []
        for q, chroma in ((yq, False), (cbq, True), (crq, True)):
            dc = q[:, :, 0]
            pred = jnp.concatenate(
                [jnp.zeros_like(dc[:, :1]), dc[:, :-1]], axis=1)
            ems.append(E_ops.block_emissions(
                q.reshape(-1, 64), pred.reshape(-1), chroma))
        N_, nm = cbq.shape[0], cbq.shape[1]
        return tuple(
            jnp.concatenate(
                [ems[0][j].reshape(N_, nm, 4, 64),
                 ems[1][j].reshape(N_, nm, 1, 64),
                 ems[2][j].reshape(N_, nm, 1, 64)], axis=2
            ).reshape(N_ * nm * 6, 64)
            for j in range(3))

    emit_fn = jax.jit(_emit_interleave)
    hilon = emit_fn(*q3)
    hilon = jax.block_until_ready(hilon)
    t_emit = device_time(lambda: emit_fn(*q3))

    pack_fn = jax.jit(E_ops.pack_block_words)
    wb = pack_fn(*hilon)
    wb = jax.block_until_ready(wb)
    t_pack = device_time(lambda: pack_fn(*hilon))

    from jpezy_tpu.codec.jax_codec import stream_budget_words_batch
    nm6 = q3[1].shape[1] * 6
    maxw_b = stream_budget_words_batch(nm6)
    wordsN = jax.block_until_ready(wb[0].reshape(batch_n, nm6, -1))
    bitsN = jax.block_until_ready(wb[1].reshape(batch_n, nm6))
    concat_fn = jax.jit(
        lambda ww, bb: E_ops.concat_device_batch(ww, bb, maxw_b))
    cc = concat_fn(wordsN, bitsN)
    jax.block_until_ready(cc)
    t_concat = device_time(lambda: concat_fn(wordsN, bitsN))

    scan_fn = jax.jit(_ft.partial(_dseg, max_blocks=RI * 6))
    sc = scan_fn(words_dev, nblk_dev, lut_dev, tsel_dev, rawlen_dev)
    jax.block_until_ready(sc)
    t_scan_only = device_time(
        lambda: scan_fn(words_dev, nblk_dev, lut_dev, tsel_dev, rawlen_dev))

    stage_attr = {
        "quantize_ms": round(t_quant * 1e3, 2),
        "emissions_ms": round(t_emit * 1e3, 2),
        "pack_ms": round(t_pack * 1e3, 2),
        "concat_ms": round(t_concat * 1e3, 2),
        "encode_fused_ms": round(t_dev * 1e3, 2),
        "encode_device_mps": round(batch_n * mp / t_dev, 1),
        "decode_scan_ms": round(t_scan_only * 1e3, 2),
        "decode_scan_mps": round(batch_n * mp / t_scan_only, 1),
        "decode_backend_ms": round(t_dev_d * 1e3, 2),
    }
    log(f"device stage attribution x{batch_n}: quantize "
        f"{t_quant*1e3:.2f}ms, emissions+interleave {t_emit*1e3:.2f}ms, "
        f"pack {t_pack*1e3:.2f}ms, concat {t_concat*1e3:.2f}ms "
        f"(standalone; fused encode total {t_dev*1e3:.2f}ms = "
        f"{batch_n*mp/t_dev:.0f} MP/s); decode scan alone "
        f"{t_scan_only*1e3:.2f}ms ({batch_n*mp/t_scan_only:.0f} MP/s), "
        f"dequant+IDCT+planes {t_dev_d*1e3:.2f}ms")

    # ---- link duplex probe: serial bandwidths, then one thread uploading
    # while another fetches -- does the host<->device link overlap?
    import threading

    probe = np.random.default_rng(1).integers(
        0, 255, 8 << 20, dtype=np.uint8)
    ups, downs = [], []
    fetch_srcs = []
    for i in range(3):
        t0 = time.time()
        darr = jax.block_until_ready(jnp.asarray(probe))
        ups.append(time.time() - t0)
        t0 = time.time()
        _ = np.asarray(darr)
        downs.append(time.time() - t0)
        fetch_srcs.append(jax.block_until_ready(jnp.asarray(probe + i)))
    up_bw = probe.nbytes / min(ups)
    down_bw = probe.nbytes / min(downs)
    NCONC = 3
    barrier = threading.Barrier(2)

    def _upw():
        barrier.wait()
        for _ in range(NCONC):
            jax.block_until_ready(jnp.asarray(probe))

    def _downw():
        barrier.wait()
        for i in range(NCONC):
            np.asarray(fetch_srcs[i])

    th1 = threading.Thread(target=_upw); th2 = threading.Thread(target=_downw)
    t0 = time.time(); th1.start(); th2.start(); th1.join(); th2.join()
    t_conc = time.time() - t0
    t_serial_pred = NCONC * (min(ups) + min(downs))
    t_duplex_pred = NCONC * max(min(ups), min(downs))
    overlap = (t_serial_pred - t_conc) / max(1e-9,
                                             t_serial_pred - t_duplex_pred)
    overlap = max(0.0, min(1.0, overlap))
    # per-batch round-trip bytes actually moved by the best configs
    bound_serial = 1.0 / (1.5e6 / up_bw + 1.5e6 / down_bw)
    bound_duplex = 1.0 / max(1.5e6 / up_bw, 1.5e6 / down_bw)
    # the proven bound interpolates by the MEASURED overlap capability
    t_px = (1 - overlap) * (1.5e6 / up_bw + 1.5e6 / down_bw) \
        + overlap * max(1.5e6 / up_bw, 1.5e6 / down_bw)
    bound_proven = 1.0 / t_px
    log(f"link probe (8 MiB): upload {up_bw/2**20:.1f} MiB/s, fetch "
        f"{down_bw/2**20:.1f} MiB/s; concurrent up+down {t_conc:.2f}s vs "
        f"serialized prediction {t_serial_pred:.2f}s / duplex prediction "
        f"{t_duplex_pred:.2f}s -> measured overlap {overlap*100:.0f}% -> "
        f"round-trip bound {bound_proven:.1f} MP/s (half-duplex "
        f"{bound_serial:.1f}, full-duplex {bound_duplex:.1f})")

    # ---- ADAPTIVE pipelined steady state: ONE config,
    # chosen by the bench's own probes rather than a max() sweep:
    #   - stream/transport: whichever serial config measured faster above
    #     (standard+ycc420 vs restart+device)
    #   - lookahead: 1 unless the duplex probe measured enough overlap to
    #     keep a second in-flight batch useful
    # Every image is encoded to complete JFIF bytes and re-decoded.
    from jpezy_tpu.runtime import pipeline

    use_ri = v_serial_ri >= v_serial
    la = 2 if overlap >= 0.4 else 1
    kw = (dict(transport="device", restart_interval=RI) if use_ri
          else dict(transport=transport))
    kw["lookahead"] = la
    best_cfg = (f"{f'DRI={RI}+device' if use_ri else 'std'}, la={la} "
                f"(probe-chosen: serial {'restart' if use_ri else 'std'} "
                f"faster, overlap {overlap*100:.0f}%)")
    log(f"pipeline config chosen by probes: {best_cfg}")
    for _ in pipeline.roundtrip_batches(iter(batches[:2]), **kw):
        pass                                        # warm the pipeline path

    def serial_now():
        t0 = time.time()
        if use_ri:
            s_now = jax_codec.encode_batch(batches[0], restart_interval=RI)
            jax_codec.decode_batch(s_now, transport="device")
        else:
            s_now = jax_codec.encode_batch(batches[0])
            jax_codec.decode_batch(s_now, transport=transport)
        return batch_n * mp / (time.time() - t0)

    # serial rate measured immediately before AND after the pipelined
    # passes, so a drift during the run shows
    v_serial_before = serial_now()
    n_meas = 6
    passes = []
    for rep in range(4):
        t0 = time.time()
        got = 0
        for streams_p, pix in pipeline.roundtrip_batches(
                (batches[i % 2] for i in range(n_meas)), **kw):
            got += len(streams_p)
            assert pix.shape[1:] == (h, w, 3)
        t_pipe = time.time() - t0
        v = got * mp / t_pipe
        passes.append(v)
        log(f"round-trip (pipelined x{n_meas} batches, {best_cfg}, pass "
            f"{rep}): {t_pipe*1000:.0f}ms total, {v:.2f} MP/s")
    v_serial_after = serial_now()
    v_serial_now = (v_serial_before + v_serial_after) / 2
    v_pipelined = float(np.median(passes))
    # the 1.5 B/px bound counts only the pixel planes; the pipeline also
    # moves the stream-word fetch (~0.8 MiB/batch) and the entropy upload
    # (~0.25 MiB/batch) -- the fair serialized-link bound for THIS config:
    bytes_up = 1.5 * batch_n * mp * 1e6 + 0.25 * 2**20
    bytes_down = 1.5 * batch_n * mp * 1e6 + 0.8 * 2**20
    bound_actual = batch_n * mp / (bytes_up / up_bw + bytes_down / down_bw)
    log(f"pipelined median of {len(passes)} passes: {v_pipelined:.2f} MP/s "
        f"[{best_cfg}] = {v_pipelined/bound_proven*100:.0f}% of the "
        f"measured-overlap bound ({v_pipelined/bound_serial*100:.0f}% of "
        f"half-duplex, {v_pipelined/bound_actual*100:.0f}% of the "
        f"actual-bytes serialized bound {bound_actual:.1f} MP/s); "
        f"pass range {min(passes):.2f}-{max(passes):.2f}; "
        f"serial same-weather {v_serial_before:.2f}/{v_serial_after:.2f} "
        f"(before/after) -> {v_serial_now:.2f}; "
        f"min pass / serial = {min(passes)/max(v_serial_now,1e-9):.2f}x")
    value = max(v_pipelined, v_serial_now)

    # quality gate: the fast decode of the last pipelined batch's first
    # stream is no worse than 0.1 dB below the oracle's decode of the same
    # stream (the reference's double math).  A HARD failure, so a quality
    # regression cannot hide behind MP/s.
    src_b = batches[(n_meas - 1) % 2]
    ro, go, bo, _ = _oracle.decode(streams_p[0])
    psnr_o = 10 * np.log10(255**2 / np.mean(
        (np.stack([ro, go, bo], -1).astype(float) - src_b[0].astype(float))
        ** 2))
    psnr_p = 10 * np.log10(255**2 / np.mean(
        (pix[0].astype(float) - src_b[0].astype(float)) ** 2))
    log(f"pipelined stream quality: fast decode {psnr_p:.3f} dB vs oracle "
        f"decode {psnr_o:.3f} dB (gate: fast >= oracle - 0.1) [{card}]")
    if psnr_p < psnr_o - 0.1:
        raise RuntimeError(
            f"PSNR gate failed: {psnr_p:.3f} < {psnr_o:.3f} - 0.1 dB")

    result = {
        "metric": metric_name,
        "value": round(value, 3),
        "unit": "MP/s",
        "vs_baseline": round(value / REF_ROUNDTRIP_MPS, 2),
        "roundtrip_pipelined": round(v_pipelined, 3),
        "pipelined_config": best_cfg,
        "roundtrip_serial": round(v_serial, 3),
        "roundtrip_serial_restart": round(v_serial_ri, 3),
        "decode_transport": transport,
        "decode_ms_ycc420": round(t_tr["ycc420"] * 1e3, 1),
        "decode_ms_rgb": round(t_tr["rgb"] * 1e3, 1),
        "decode_ms_indexed": (round(t_tr["indexed"] * 1e3, 1)
                              if "indexed" in t_tr else None),
        "decode_ms_device": round(t_ri["device"] * 1e3, 1),
        "single_roundtrip_ms": round(t_single_rt * 1e3, 1),
        "single_roundtrip_device_ms": round(t_single_dev * 1e3, 1),
        "single_roundtrip_host_ms": (
            None if t_enc_h == float("inf")
            else round((t_enc_h + t_dec_h) * 1e3, 1)),
        "single_beats_reference": bool(t_single_rt < 0.097),
        "psnr_fast_db": round(psnr_fast, 3),
        "psnr_exact_db": round(psnr_exact, 3),
        "decode_attribution": dec_attr,
        "device_stage_attribution": stage_attr,
        "link_overlap_pct": round(overlap * 100, 1),
        "link_bound_halfduplex": round(bound_serial, 2),
        "link_bound_proven": round(bound_proven, 2),
        "pipelined_pct_of_bound": round(v_pipelined / bound_proven * 100, 1),
        "link_bound_actual_bytes": round(bound_actual, 2),
        "serial_sameweather": round(v_serial_now, 3),
        "pipelined_vs_serial_sameweather": round(
            v_pipelined / max(v_serial_now, 1e-9), 2),
        "pipelined_passes": [round(p, 2) for p in passes],
        "min_pass_vs_serial_sameweather": round(
            min(passes) / max(v_serial_now, 1e-9), 2),
    }
    # ---- 4K single-image latency (BASELINE config 4).
    # Uses the batched entry points at N=1: they carry the lean transports
    # (ycc420 planes up, sparse coefficients + planes down).
    big4k = np.tile(batches[0][0], (8, 8, 1))[None]  # [1,4096,4096,3]
    s4k = jax_codec.encode_batch(big4k)
    jax_codec.decode_batch(s4k)                  # compile at 4K shapes
    ts_e, ts_d = [], []
    for _ in range(3):
        t0 = time.time()
        s4k = jax_codec.encode_batch(big4k)
        ts_e.append(time.time() - t0)
        t0 = time.time()
        jax_codec.decode_batch(s4k)
        ts_d.append(time.time() - t0)
    mp4k = 4096 * 4096 / 1e6
    v_4k = mp4k / (min(ts_e) + min(ts_d))
    log(f"4K single image: encode {min(ts_e)*1e3:.0f}ms "
        f"({mp4k/min(ts_e):.1f} MP/s), decode {min(ts_d)*1e3:.0f}ms "
        f"({mp4k/min(ts_d):.1f} MP/s), round-trip {v_4k:.2f} MP/s")
    result["roundtrip_4k_single"] = round(v_4k, 3)
    # restart variant: decode auto-picks the device entropy decoder
    # (raw entropy bytes up instead of ~9 MiB of sparse coefficients)
    s4k_ri = jax_codec.encode_batch(big4k, restart_interval=RI)
    jax_codec.decode_batch(s4k_ri)               # compile (device path)
    ts_e2, ts_d2 = [], []
    for _ in range(2):
        t0 = time.time()
        s4k_ri = jax_codec.encode_batch(big4k, restart_interval=RI)
        ts_e2.append(time.time() - t0)
        t0 = time.time()
        jax_codec.decode_batch(s4k_ri)
        ts_d2.append(time.time() - t0)
    v_4k_ri = mp4k / (min(ts_e2) + min(ts_d2))
    log(f"4K single image (DRI={RI}, device entropy decode): encode "
        f"{min(ts_e2)*1e3:.0f}ms, decode {min(ts_d2)*1e3:.0f}ms, "
        f"round-trip {v_4k_ri:.2f} MP/s")
    result["roundtrip_4k_restart_device"] = round(v_4k_ri, 3)

    # ---- restart-free entropy decode (host; SURVEY 2.7).  A single large
    # restart-free stream is the serial-chain worst case the reference
    # embodies (jpezy_decoder.hpp:583-642).  The production path is the
    # destuffed fast serial decoder (the speculative-resync decoder was
    # retired after losing every measured race on a 2-core host --
    # docs/DESIGN.md section 5).
    from jpezy_tpu.bitstream.reader import parse as _parse
    from jpezy_tpu.runtime import native as _nat

    # dense content (noise) so the stream is entropy-heavy -- a smooth
    # image decodes serially in single-digit ms
    rng = np.random.default_rng(99)
    big = rng.integers(0, 256, (2048, 2048, 3), np.uint8)
    bstream = jax_codec.encode(big[..., 0], big[..., 1], big[..., 2])
    pj = _parse(bstream)
    log(f"  (noise stream: {len(bstream)} bytes)")
    n_mcus = (2048 // 16) ** 2
    t0 = time.time()
    _nat.entropy_decode(pj, n_mcus)
    t_ser = time.time() - t0
    log(f"entropy decode 2048x2048 restart-free: fast serial "
        f"{t_ser*1e3:.0f}ms")
    # index-assisted two-pass (SURVEY 2.7 option b):
    # pass-1 length-only scan cost, then the full two-pass e2e decode
    t0 = time.time()
    _nat.index_scan(pj, n_mcus, 8)
    t_scan = time.time() - t0
    jax_codec.decode(bstream, transport="indexed")     # compile
    ts_i, ts_h = [], []
    for _ in range(3):
        t0 = time.time()
        jax_codec.decode(bstream, transport="indexed")
        ts_i.append(time.time() - t0)
        t0 = time.time()
        jax_codec.decode(bstream, transport="ycc420")
        ts_h.append(time.time() - t0)
    log(f"index-assisted decode 2048x2048 restart-free: pass-1 scan "
        f"{t_scan*1e3:.0f}ms (vs {t_ser*1e3:.0f}ms full serial), e2e "
        f"indexed {min(ts_i)*1e3:.0f}ms vs host-frontend "
        f"{min(ts_h)*1e3:.0f}ms")
    result["indexed_pass1_ms"] = round(t_scan * 1e3, 1)
    result["indexed_e2e_ms"] = round(min(ts_i) * 1e3, 1)
    result["hostfront_e2e_ms"] = round(min(ts_h) * 1e3, 1)

    return result


def main() -> int:
    import jax

    from jpezy_tpu.utils.profiling import card_lines

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench: needs a GPU; JAX found {dev.platform}")
        return 1
    print(json.dumps(measure(card_lines()[0])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
