"""Single-chip JAX codec pipelines (the device fast path).

Encode: one jitted program from RGB planes to per-block packed entropy words;
the host then splices block bitstrings, stuffs bytes, and prepends the JFIF
header (jpezy_tpu.bitstream).  Decode: host entropy frontend produces [B, 64]
coefficient blocks; one jitted program dequantizes, IDCTs, upsamples and
color-converts back to RGB planes.

precision:
  "fast"  - float32 transforms (default; identical stream validity/quality,
            rare +-1 coefficient/pixel differences vs the reference's doubles)
  "exact" - float64 transforms, bit-identical to the numpy oracle / the
            reference's double math (requires jax_enable_x64).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core import tables as T
from ..core.geometry import ComponentGeometry, EncodeGeometry
from ..core.props import ImageProps, make_encode_props
from ..bitstream import writer
from ..bitstream.reader import (ParsedJpeg, check_decodable as
                                _check_decodable, parse,
                                split_entropy_segments)
from ..bitstream.splice import splice_blocks
from ..ops import blocks as B
from ..ops import colorspace as C
from ..ops import dct as D
from ..ops import entropy as E
from ..ops import quantize as Q


def _dtype(precision: str):
    if precision == "exact":
        if not jax.config.jax_enable_x64:
            raise ValueError(
                "precision='exact' needs float64: set jax.config.update('jax_enable_x64', True)"
            )
        return jnp.float64
    return jnp.float32


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def stream_budget_words(nblocks: int) -> int:
    """Device-splice output budget: ~2 bits/pixel equivalent, fast-transfer
    sized.  Overflow falls back to the per-block words path."""
    return max(4096, nblocks * 4)


@functools.partial(jax.jit, static_argnames=(
    "ph", "pw", "gray", "precision", "rounded", "quality", "restart_interval"))
def encode_to_blocks(r, g, b, *, ph: int, pw: int, gray: bool,
                     precision: str = "fast", rounded: bool = False,
                     quality: int | None = None, restart_interval: int = 0):
    """RGB planes [H, W] uint8 -> per-block entropy words + bit counts.

    Returns (words [nmcu*6, 64] uint32, bits [nmcu*6] int32) in MCU emission
    order Y0 Y1 Y2 Y3 Cb Cr.

    restart_interval > 0 (extension) resets the DC predictor chains every
    that many MCUs (T.81 F.2.1.3.1) so segments entropy-decode independently.
    """
    yq, cbq, crq = quantize_planes(
        r, g, b, ph=ph, pw=pw, gray=gray, precision=precision,
        rounded=rounded, quality=quality,
    )
    return _emit_interleave_pack(yq, cbq, crq, restart_interval)


@functools.partial(jax.jit, static_argnames=(
    "ph", "pw", "gray", "precision", "rounded", "quality"))
def quantize_planes(r, g, b, *, ph: int, pw: int, gray: bool,
                    precision: str = "fast", rounded: bool = False,
                    quality: int | None = None):
    """RGB planes -> quantized coefficient blocks (yq [nm*4,64], cbq, crq
    [nm,64] int32), the shared front half of every encode pipeline."""
    dt = _dtype(precision)
    y, cb, cr = C.rgb_to_ycc(r, g, b, dt)
    y = B.pad_replicate(y, ph, pw)
    cb = B.decimate_420(B.pad_replicate(cb, ph, pw))
    cr = B.decimate_420(B.pad_replicate(cr, ph, pw))

    yb = B.blockify_luma(y)
    cbb = B.blockify_chroma(cb)
    crb = B.blockify_chroma(cr)
    if gray:
        cbb = jnp.zeros_like(cbb)
        crb = jnp.zeros_like(crb)

    yqt, cqt = (T.scale_quant_tables(quality) if quality is not None
                else (T.Y_QUANT, T.C_QUANT))
    yq = Q.quantize(D.forward_dct(yb, dt), chroma=False, rounded=rounded, qtable=yqt)
    cbq = Q.quantize(D.forward_dct(cbb, dt), chroma=True, rounded=rounded, qtable=cqt)
    crq = Q.quantize(D.forward_dct(crb, dt), chroma=True, rounded=rounded, qtable=cqt)
    return yq, cbq, crq


def _emit_interleave_pack(yq, cbq, crq, restart_interval: int,
                          ytables=None, ctables=None):
    """Quantized blocks -> packed per-block words+bits in MCU emission order.

    ytables/ctables: optional custom flat Huffman tables (see
    ops.entropy.block_emissions); None = fixed Annex K."""
    ems = [
        E.block_emissions(
            q, E.dc_predictors_restart(q[:, 0], restart_interval * bpm),
            chroma, tables=tabs)
        for q, chroma, bpm, tabs in (
            (yq, False, 4, ytables), (cbq, True, 1, ctables),
            (crq, True, 1, ctables))
    ]
    nm = cbq.shape[0]
    # interleave emissions to MCU order (Y0..Y3, Cb, Cr), then pack ONCE
    hi, lo, n = (
        jnp.concatenate(
            [ems[0][j].reshape(nm, 4, 64), ems[1][j].reshape(nm, 1, 64),
             ems[2][j].reshape(nm, 1, 64)], axis=1
        ).reshape(nm * 6, 64)
        for j in range(3)
    )
    return E.pack_block_words(hi, lo, n)


def _concat_combined(words, bits, restart_interval: int):
    """Device splice + single-fetch `combined` layout (see encode_to_stream)."""
    maxw = stream_budget_words(words.shape[0])
    if restart_interval:
        stream, total, seg_bits = E.concat_device_restart(
            words, bits, maxw, 6 * restart_interval)
        return jnp.concatenate(
            [total[None].astype(jnp.uint32), seg_bits.astype(jnp.uint32),
             stream])
    stream, total = E.concat_device(words, bits, maxw)
    return jnp.concatenate([total[None].astype(jnp.uint32), stream])


@functools.partial(jax.jit, static_argnames=("restart_interval",))
def _symbol_histograms(yq, cbq, crq, *, restart_interval: int = 0):
    """Pass 1 of the two-pass optimized encode: Huffman symbol frequencies.

    Returns [4, 256] int32: Y-DC, Y-AC, C-DC, C-AC counts (both chroma
    components share one table pair, like the reference's fixed tables)."""
    ri = restart_interval
    ydc, yac = E.symbol_histograms(yq, E.dc_predictors_restart(yq[:, 0], ri * 4))
    bdc, bac = E.symbol_histograms(cbq, E.dc_predictors_restart(cbq[:, 0], ri))
    rdc, rac = E.symbol_histograms(crq, E.dc_predictors_restart(crq[:, 0], ri))
    return jnp.stack([ydc, yac, bdc + rdc, bac + rac])


@functools.partial(jax.jit, static_argnames=(
    "ph", "pw", "gray", "precision", "rounded", "quality", "restart_interval"))
def encode_to_stream(r, g, b, *, ph: int, pw: int, gray: bool,
                     precision: str = "fast", rounded: bool = False,
                     quality: int | None = None, restart_interval: int = 0):
    """Like encode_to_blocks but splices the stream ON DEVICE.

    Returns (combined uint32, words, bits): combined[0] is the total bit
    count, then (with restart_interval) S per-segment bit counts, then the
    packed stream.  A single array fetch retrieves everything on the fast
    path; `words`/`bits` are fetched only if the budget overflowed.
    With restart_interval, each segment starts byte-aligned in the stream
    (see ops.entropy.concat_device_restart).
    """
    words, bits = encode_to_blocks(
        r, g, b, ph=ph, pw=pw, gray=gray, precision=precision,
        rounded=rounded, quality=quality, restart_interval=restart_interval,
    )
    return _concat_combined(words, bits, restart_interval), words, bits


def _stream_to_bytes(stream: np.ndarray, total: int) -> bytes:
    nbytes = (total + 7) // 8
    raw = bytearray(stream.astype(">u4").tobytes()[:nbytes])
    pad = (-total) % 8
    if pad:
        raw[-1] |= (1 << pad) - 1  # T.81 F.1.2.3 one-padding
    return bytes(raw)


def _splice_restart_raw(nw: np.ndarray, nb: np.ndarray, S: int,
                        ri: int, seg_bits: np.ndarray) -> bytes:
    """Host splice of per-block words into byte-aligned restart segments
    (the overflow fallback mirroring concat_device_restart's layout)."""
    raw_parts = []
    for s in range(S):
        sl = slice(s * 6 * ri, (s + 1) * 6 * ri)
        seg_raw, sb = splice_blocks(
            np.ascontiguousarray(nw[sl]), np.ascontiguousarray(nb[sl]))
        # splice 1-pads the tail; _assemble_restart_segments re-ORs the
        # same bits
        raw_parts.append(seg_raw)
        assert sb == int(seg_bits[s])
    return b"".join(raw_parts)


def _assemble_restart_segments(raw: bytes, seg_bits: np.ndarray) -> bytes:
    """Join byte-aligned segments with 1-padding, stuffing and RSTn markers.

    raw: device stream bytes where segment s sits at byte offset
    sum(ceil(seg_bits[:s]/8)) (concat_device_restart layout).  RSTn markers
    are emitted between segments, indices cycling 0..7 (T.81 E.1.2), and are
    NOT byte-stuffed (they are markers, not entropy data).
    """
    parts = []
    base = 0
    S = len(seg_bits)
    for s in range(S):
        sb = int(seg_bits[s])
        nb = (sb + 7) // 8
        seg = bytearray(raw[base : base + nb])
        pad = (-sb) % 8
        if pad:
            seg[-1] |= (1 << pad) - 1  # T.81 F.1.2.3 one-padding
        parts.append(writer.byte_stuff(bytes(seg)))
        if s != S - 1:
            parts.append(bytes([0xFF, 0xD0 + (s % 8)]))
        base += nb
    return b"".join(parts)


def encode(r: np.ndarray, g: np.ndarray, b: np.ndarray,
           props: ImageProps | None = None, *, gray: bool = False,
           precision: str = "fast", rounded: bool = False,
           quality: int | None = None, restart_interval: int = 0,
           optimize: bool = False) -> bytes:
    """Full encode: RGB planes [H, W] uint8 -> baseline JFIF bytes.

    Routes through the batch transports at N=1 (VERDICT r3 #2): host
    float64 color (the reference's exact double math,
    jpezy_encoder.hpp:245-256) -> one packed int8 YCC 4:2:0 upload
    (1.5 B/px, half of RGB) -> one combined-stream fetch.

    quality (extension): libjpeg-style scaling of the Annex K tables;
    None = the reference's fixed tables.
    restart_interval (extension): emit DRI + RSTn every that many MCUs
    (the reference never does, README.md:33) -- enables parallel entropy
    decode of our own streams (host jz_entropy_decode_mt or the device
    segment decoder).
    optimize (extension): two-pass encode with per-image optimal Huffman
    tables (the libjpeg -optimize analog): pass 1 histograms the symbols on
    device (one tiny [4,256] fetch), the host derives optimal code lengths
    (T.81 Annex K.2), pass 2 re-codes the device-resident coefficients with
    the custom tables.  Typically 2-8%% smaller files, identical pixels."""
    h, w = r.shape
    if restart_interval < 0:
        raise ValueError(f"restart_interval must be >= 0, got {restart_interval}")
    geo = EncodeGeometry(width=w, height=h)
    # edge-replicate to the MCU grid on HOST so the jitted program's shape
    # key is the PADDED grid only: distinct true sizes sharing a grid reuse
    # one compiled program (VERDICT r2 #8).  Padding commutes with the
    # pointwise color conversion, and pad_replicate on already-padded
    # planes is the identity, so streams are bit-identical.
    stacked = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)])
    ph_, pw_ = geo.padded_height, geo.padded_width
    if (h, w) != (ph_, pw_):
        stacked = np.pad(
            stacked, ((0, 0), (0, ph_ - h), (0, pw_ - w)), mode="edge")
    ticket = encode_batch_dispatch(
        np.moveaxis(stacked, 0, -1)[None], gray=gray, precision=precision,
        rounded=rounded, quality=quality, restart_interval=restart_interval,
        optimize=optimize, _props=props,
        _size=None if (h, w) == (ph_, pw_) else (w, h),
    )
    return encode_batch_finish(ticket)[0]


def stream_budget_words_batch(nblocks: int) -> int:
    """Batched-path stream budget: 2 words/block = 1 bit/pixel equivalent.

    Annex-K 4:2:0 streams run ~0.3-0.7 bits/px (lena 512x512 = 18,010 bytes
    = 0.55 b/px), so this is ~2x headroom while keeping the per-batch fetch
    small (the fetch is on the critical path).
    Overflowing images fall back to a per-image words fetch in
    encode_batch_finish."""
    return max(4096, nblocks * 2)


def _concat_batch_combined(words, bits, restart_interval: int):
    """Batched device splice -> `combined` [N, R + maxw] uint32 (R = 1
    total-bits word, plus per-segment bit counts with restarts)."""
    N, Bn, W = words.shape
    maxw = stream_budget_words_batch(Bn)
    if restart_interval:
        stream, total, seg_bits = E.concat_device_restart_batch(
            words, bits, maxw, 6 * restart_interval)
        return jnp.concatenate(
            [total[:, None].astype(jnp.uint32),
             seg_bits.astype(jnp.uint32), stream], axis=1)
    streams, totals = E.concat_device_batch(words, bits, maxw)
    return jnp.concatenate(
        [totals[:, None].astype(jnp.uint32), streams], axis=1)


def _concat_batch_combined_comp(wc, bc, restart_interval: int):
    """Batched device splice from PER-COMPONENT packed words (no MCU
    interleave of the big [B, W] arrays on device: the stream scatter is
    order-independent, so blocks scatter from component order with
    MCU-ordered global bit offsets -- only the tiny [N, nm*6] bits array
    is interleaved).  Returns (combined, words_comp [N, nm*6, W] in
    component order, bits_mcu [N, nm*6] in MCU order); overflow fallbacks
    reorder the words on HOST (encode_batch_finish)."""
    N, nm = bc[1].shape
    bits_mcu = jnp.concatenate(
        [bc[0].reshape(N, nm, 4), bc[1].reshape(N, nm, 1),
         bc[2].reshape(N, nm, 1)], axis=2).reshape(N, nm * 6)
    maxw = stream_budget_words_batch(nm * 6)
    if restart_interval:
        goff, total, seg_bits = E.stream_offsets_restart_batch(
            bits_mcu, 6 * restart_interval)
    else:
        goff, total = E.stream_offsets_batch(bits_mcu)
        seg_bits = None
    g6 = goff.reshape(N, nm, 6)
    goff_c = jnp.concatenate(
        [g6[:, :, :4].reshape(N, nm * 4), g6[:, :, 4], g6[:, :, 5]], axis=1)
    words_c = jnp.concatenate(wc, axis=1)
    bits_c = jnp.concatenate(bc, axis=1)
    stream = E._concat_batch_scatter(words_c, bits_c, goff_c, maxw)
    head = [total[:, None].astype(jnp.uint32)]
    if seg_bits is not None:
        head.append(seg_bits.astype(jnp.uint32))
    combined = jnp.concatenate(head + [stream], axis=1)
    return combined, words_c, bits_mcu


def _words_comp_to_mcu(w: np.ndarray, nm: int) -> np.ndarray:
    """Host-side reorder of one image's component-ordered packed words
    [nm*6, ...] to MCU order (overflow fallback only)."""
    return np.concatenate(
        [w[: nm * 4].reshape(nm, 4, -1),
         w[nm * 4: nm * 5].reshape(nm, 1, -1),
         w[nm * 5:].reshape(nm, 1, -1)], axis=1).reshape(nm * 6, -1)


def _batch_qtables(quality):
    return (T.scale_quant_tables(quality) if quality is not None else None)


@functools.partial(jax.jit, static_argnames=(
    "gray", "precision", "rounded", "quality", "restart_interval"))
def _encode_batch_blocks(r, g, b, *, gray=False, precision="fast",
                         rounded=False, quality=None, restart_interval=0):
    from ..parallel.sharded import _encode_local

    words, bits = _encode_local(r, g, b, gray=gray, dtype=_dtype(precision),
                                rounded=rounded, tile_axis=None,
                                qtables=_batch_qtables(quality),
                                restart_interval=restart_interval)
    return _concat_batch_combined(words, bits, restart_interval), words, bits


@functools.partial(jax.jit, static_argnames=(
    "gray", "precision", "rounded", "quality", "restart_interval"))
def _encode_batch_blocks_ycc(y, cb, cr, *, gray=False, precision="fast",
                             rounded=False, quality=None, restart_interval=0):
    from ..parallel.sharded import _encode_local_ycc

    wc, bc = _encode_local_ycc(
        y, cb, cr, gray=gray, dtype=_dtype(precision), rounded=rounded,
        tile_axis=None, qtables=_batch_qtables(quality),
        restart_interval=restart_interval, interleave=False,
    )
    return _concat_batch_combined_comp(wc, bc, restart_interval)


@functools.partial(jax.jit, static_argnames=(
    "h", "w", "gray", "precision", "rounded", "quality", "restart_interval"))
def _encode_batch_blocks_packed(packed, *, h, w, gray=False,
                                precision="fast", rounded=False,
                                quality=None, restart_interval=0):
    """Single-buffer transport: packed [N, H*W + 2*(H/2)*(W/2)] int8 holds
    Y then Cb then Cr per image.  One host->device transfer instead of
    three (each transfer pays a fixed cost)."""
    N = packed.shape[0]
    ny, nc = h * w, (h // 2) * (w // 2)
    y = packed[:, :ny].reshape(N, h, w)
    cb = packed[:, ny : ny + nc].reshape(N, h // 2, w // 2)
    cr = packed[:, ny + nc :].reshape(N, h // 2, w // 2)
    return _encode_batch_blocks_ycc.__wrapped__(
        y, cb, cr, gray=gray, precision=precision, rounded=rounded,
        quality=quality, restart_interval=restart_interval)


def host_rgb_to_ycc420(rgbs: np.ndarray):
    """Host-side RGB -> level-shifted YCC 4:2:0 int8 planes.

    Same float64 expression order / int truncation as ops.colorspace.rgb_to_ycc
    (= the reference's double math, jpezy_encoder.hpp:245-256), with the 4:2:0
    top-left decimation (jpezy_encoder.hpp:116-143) applied BEFORE the chroma
    arithmetic (pointwise, so the order is equivalent and 4x cheaper).

    Returns (y [N,H,W] int8, cb, cr [N,H/2,W/2] int8): 1.5 bytes/pixel on the
    host->device link vs 3 for RGB.

    Uses the multithreaded C++ runtime when available (bit-identical; this
    stage is the encode pipeline's host bottleneck), else numpy float64.
    """
    try:
        from ..runtime import native

        return native.rgb_to_ycc420(np.ascontiguousarray(rgbs, np.uint8))
    except ImportError:
        pass
    rf = rgbs[..., 0].astype(np.float64)
    gf = rgbs[..., 1].astype(np.float64)
    bf = rgbs[..., 2].astype(np.float64)
    y = ((0.2990 * rf) + (0.5870 * gf) + (0.1140 * bf) - 128.0).astype(
        np.int32).astype(np.int8)
    sub = rgbs[:, 0::2, 0::2, :].astype(np.float64)
    rs, gs, bs = sub[..., 0], sub[..., 1], sub[..., 2]
    cb = (-(0.1687 * rs) - (0.3313 * gs) + (0.5000 * bs)).astype(
        np.int32).astype(np.int8)
    cr = ((0.5000 * rs) - (0.4187 * gs) - (0.0813 * bs)).astype(
        np.int32).astype(np.int8)
    return y, cb, cr


@functools.partial(jax.jit, static_argnames=(
    "gray", "precision", "rounded", "quality"))
def _quantize_batch_ycc(y, cb, cr, *, gray=False, precision="fast",
                        rounded=False, quality=None):
    from ..parallel.sharded import _quantize_local_ycc

    return _quantize_local_ycc(y, cb, cr, gray=gray, dtype=_dtype(precision),
                               rounded=rounded, qtables=_batch_qtables(quality))


def _batch_pred(q, bpm: int, restart_interval: int):
    """Per-image DC predictor rows [N, B] with restart resets."""
    dc = q[:, :, 0]
    pred = jnp.concatenate([jnp.zeros_like(dc[:, :1]), dc[:, :-1]], axis=1)
    if restart_interval > 0:
        segb = restart_interval * bpm
        idx = jnp.arange(q.shape[1], dtype=jnp.int32)[None, :]
        pred = jnp.where(idx % segb == 0, jnp.zeros_like(pred), pred)
    return pred


@functools.partial(jax.jit, static_argnames=("restart_interval",))
def _symbol_histograms_batch(yq, cbq, crq, *, restart_interval=0):
    """PER-IMAGE Huffman symbol counts [N, 4, 256] (the libjpeg -optimize
    analog, per image like the single-image path; VERDICT r1 #6)."""
    def per_comp(q, bpm):
        pred = _batch_pred(q, bpm, restart_interval)
        return jax.vmap(E.symbol_histograms)(q, pred)

    ydc, yac = per_comp(yq, 4)
    bdc, bac = per_comp(cbq, 1)
    rdc, rac = per_comp(crq, 1)
    return jnp.stack([ydc, yac, bdc + rdc, bac + rac], axis=1)


@functools.partial(jax.jit, static_argnames=("restart_interval",))
def _encode_batch_custom(yq, cbq, crq, ytables, ctables, *,
                         restart_interval=0):
    """Entropy-code a batch with PER-IMAGE custom Huffman tables.

    ytables/ctables: tuples of [N, ...] flat table arrays (leading batch
    axis).  Emissions are vmapped over images; the pack + concat run once
    over the flattened block axis.
    """
    N, nm6_y, _ = yq.shape
    nm = cbq.shape[1]
    ems = []
    for q, chroma, tabs, bpm in ((yq, False, ytables, 4),
                                 (cbq, True, ctables, 1),
                                 (crq, True, ctables, 1)):
        pred = _batch_pred(q, bpm, restart_interval)
        hi, lo, nb = jax.vmap(
            lambda qq, pp, *tt: E.block_emissions(qq, pp, chroma, tables=tt)
        )(q, pred, *tabs)
        ems.append((hi, lo, nb))
    # pack per component, then interleave the PACKED words to MCU order
    # (one relayout instead of three; same rationale as sharded._emit_local)
    packed = []
    for hi, lo, nb in ems:
        w_c, b_c = E.pack_block_words(
            hi.reshape(-1, 64), lo.reshape(-1, 64), nb.reshape(-1, 64))
        packed.append((w_c.reshape(N, -1, w_c.shape[-1]),
                       b_c.reshape(N, -1)))
    W = packed[0][0].shape[-1]
    words = jnp.concatenate(
        [packed[0][0].reshape(N, nm, 4, W),
         packed[1][0].reshape(N, nm, 1, W),
         packed[2][0].reshape(N, nm, 1, W)], axis=2).reshape(N, nm * 6, W)
    bits = jnp.concatenate(
        [packed[0][1].reshape(N, nm, 4),
         packed[1][1].reshape(N, nm, 1),
         packed[2][1].reshape(N, nm, 1)], axis=2).reshape(N, nm * 6)
    return _concat_batch_combined(words, bits, restart_interval), words, bits


def encode_batch_dispatch(rgbs: np.ndarray, *, gray: bool = False,
                          precision: str = "fast", rounded: bool = False,
                          transport: str | None = None,
                          quality: int | None = None,
                          restart_interval: int = 0,
                          optimize: bool = False,
                          _size: tuple[int, int] | None = None,
                          _props: ImageProps | None = None):
    """Asynchronously dispatch a uniform-batch encode (upload + device work).

    Returns an opaque ticket for encode_batch_finish.  JAX dispatch is
    async, so the upload and the jitted program run in the background while
    the host moves on (see runtime/pipeline.py).

    transport: "ycc420" converts RGB->YCC 4:2:0 on the host (float64, the
    reference's exact truncation) and uploads int8 planes -- half the link
    bytes of "rgb", which uploads raw planes and converts on device.
    Default ycc420: identical streams in exact mode; in fast mode it is the
    float64 color conversion (closer to the reference than float32).

    quality / restart_interval / optimize: the same extensions as encode()
    (docs/PARITY.md matrix).  optimize derives PER-IMAGE optimal Huffman
    tables (one [N,4,256] histogram fetch, vmapped pass-2 emissions);
    implies ycc420 transport."""
    n, h, w = rgbs.shape[:3]
    if h % 16 or w % 16:
        raise ValueError("encode_batch needs multiple-of-16 dims")
    if restart_interval < 0:
        raise ValueError(
            f"restart_interval must be >= 0, got {restart_interval}")
    ri = restart_interval
    if transport is None:
        transport = "ycc420"
    if optimize:
        y, cb, cr = host_rgb_to_ycc420(rgbs)
        yq, cbq, crq = _quantize_batch_ycc(
            jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr),
            gray=gray, precision=precision, rounded=rounded, quality=quality,
        )
        hists = np.asarray(_symbol_histograms_batch(yq, cbq, crq,
                                                    restart_interval=ri))
        yflats, cflats, huffs = [], [], []
        for i in range(n):
            ydc_bv, yac_bv, *yflat = T.optimal_flat_tables(
                hists[i, 0], hists[i, 1])
            cdc_bv, cac_bv, *cflat = T.optimal_flat_tables(
                hists[i, 2], hists[i, 3])
            yflats.append(yflat)
            cflats.append(cflat)
            huffs.append((ydc_bv, cdc_bv, yac_bv, cac_bv))
        ytables = tuple(jnp.asarray(np.stack([f[k] for f in yflats]))
                        for k in range(4))
        ctables = tuple(jnp.asarray(np.stack([f[k] for f in cflats]))
                        for k in range(4))
        combined, words, bits = _encode_batch_custom(
            yq, cbq, crq, ytables, ctables, restart_interval=ri)
        return dict(combined=combined, words=words, bits=bits, n=n, h=h,
                    w=w, gray=gray, huff=huffs, ri=ri, quality=quality,
                    size=_size, props=_props)
    words_order = "mcu"
    if transport == "ycc420":
        y, cb, cr = host_rgb_to_ycc420(rgbs)
        packed = np.concatenate(
            [y.reshape(n, -1), cb.reshape(n, -1), cr.reshape(n, -1)], axis=1)
        combined, words, bits = _encode_batch_blocks_packed(
            jnp.asarray(packed), h=h, w=w,
            gray=gray, precision=precision, rounded=rounded,
            quality=quality, restart_interval=ri,
        )
        words_order = "comp"    # _concat_batch_combined_comp layout
    else:
        combined, words, bits = _encode_batch_blocks(
            jnp.asarray(rgbs[..., 0]), jnp.asarray(rgbs[..., 1]),
            jnp.asarray(rgbs[..., 2]), gray=gray, precision=precision,
            rounded=rounded, quality=quality, restart_interval=ri,
        )
    return dict(combined=combined, words=words, bits=bits, n=n, h=h, w=w,
                gray=gray, huff=None, ri=ri, quality=quality, size=_size,
                props=_props, words_order=words_order)


def encode_batch_finish(ticket) -> list[bytes]:
    """Block on a dispatched batch encode and assemble the JFIF streams."""
    combined, words, bits = ticket["combined"], ticket["words"], ticket["bits"]
    n, h, w = ticket["n"], ticket["h"], ticket["w"]
    gray, huff, ri, quality = (ticket["gray"], ticket["huff"], ticket["ri"],
                               ticket["quality"])
    combined = np.asarray(combined)  # ONE fetch for the whole batch
    geo = EncodeGeometry(width=w, height=h)
    S = -(-geo.num_mcus // ri) if ri else 0
    maxw = combined.shape[1] - 1 - S
    qt = T.scale_quant_tables(quality) if quality is not None else None
    # headers carry the TRUE dims when the caller padded to the MCU grid
    # (the single-image path, VERDICT r2 #8); the grid is unchanged by the
    # pad, so only the SOF0 W/H differ
    tw, th = ticket["size"] or (w, h)
    props = ticket["props"] or make_encode_props(tw, th, gray=gray)
    if not isinstance(huff, list):
        header = writer.write_header(props, restart_interval=ri,
                                     quant_tables=qt, huff_tables=huff)

    def _wmcu(i):
        """Per-image words in MCU order (overflow fallback only): the
        fast transport keeps words in component order on device."""
        wi = np.asarray(words[i])
        if ticket.get("words_order") == "comp":
            wi = _words_comp_to_mcu(wi, geo.num_mcus)
        return wi

    out = []
    for i in range(n):
        if isinstance(huff, list):  # per-image optimal tables
            header = writer.write_header(props, restart_interval=ri,
                                         quant_tables=qt,
                                         huff_tables=huff[i])
        total = int(combined[i, 0])
        if ri:
            seg_bits = combined[i, 1 : 1 + S]
            if total <= 32 * maxw:
                raw = combined[i, 1 + S :].astype(">u4").tobytes()
            else:  # overflow: host splice for this image only (ADVICE r2)
                raw = _splice_restart_raw(
                    _wmcu(i), np.asarray(bits[i]), S, ri, seg_bits)
            out.append(header + _assemble_restart_segments(raw, seg_bits)
                       + writer.EOI)
            continue
        if total <= 32 * maxw:
            packed = _stream_to_bytes(combined[i, 1:], total)
        else:  # overflow: host splice for this image only
            packed, _ = splice_blocks(_wmcu(i), np.asarray(bits[i]))
        out.append(writer.assemble(header, packed))
    return out


def encode_batch(rgbs: np.ndarray, *, gray: bool = False,
                 precision: str = "fast", rounded: bool = False,
                 transport: str | None = None, quality: int | None = None,
                 restart_interval: int = 0,
                 optimize: bool = False) -> list[bytes]:
    """Encode a uniform batch [N, H, W, 3] uint8 -> list of JFIF streams.

    H, W must be multiples of 16 (use encode() per image otherwise; batched
    mixed sizes go through bucketing in jpezy_tpu.runtime.batch).
    transport / quality / restart_interval / optimize: see
    encode_batch_dispatch.
    """
    return encode_batch_finish(encode_batch_dispatch(
        rgbs, gray=gray, precision=precision, rounded=rounded,
        transport=transport, quality=quality,
        restart_interval=restart_interval, optimize=optimize))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("mcus_y", "mcus_x", "v", "h", "dup_y", "dup_x", "level", "precision"),
)
def decode_component_plane(coeff_blocks, qtable, *, mcus_y, mcus_x, v, h,
                           dup_y, dup_x, level, precision="fast"):
    """[B, 64] coefficient blocks -> upsampled int32 component plane."""
    dt = _dtype(precision)
    deq = Q.dequantize(coeff_blocks, qtable)
    spat = D.inverse_dct(deq, level, dt)
    plane = B.deblockify(spat, mcus_y, mcus_x, v, h)
    return B.upsample_nearest(plane, dup_y, dup_x)


@functools.partial(
    jax.jit,
    static_argnames=("geom", "level", "gray", "precision"),
)
def _decode_fused(comp_blocks, qtables, *, geom, level, gray, precision):
    """One jitted program for the whole device decode backend.

    comp_blocks: tuple of [B_i, 64] coefficient arrays (one per component);
    qtables: tuple of [64] quant tables; geom: tuple of
    (mcus_y, mcus_x, v, h, dup_y, dup_x) per component.
    Returns interleaved uint8 [H_mcu, W_mcu, 3] (or [H, W, 1] luma for
    1-component/gray) so the host needs exactly ONE fetch.
    """
    dt = _dtype(precision)
    planes = []
    for cb, qt, (mcus_y, mcus_x, v, h, dup_y, dup_x) in zip(
        comp_blocks, qtables, geom
    ):
        deq = Q.dequantize(cb, qt)
        spat = D.inverse_dct(deq, level, dt)
        plane = B.deblockify(spat, mcus_y, mcus_x, v, h)
        planes.append(B.upsample_nearest(plane, dup_y, dup_x))
    if gray or len(planes) == 1:
        return C.clamp_gray(planes[0], dt)[..., None]
    r, g, b = C.ycc_to_rgb(planes[0], planes[1], planes[2], dt)
    return jnp.stack([r, g, b], axis=-1)


@functools.partial(jax.jit, static_argnames=("geom", "level", "gray",
                                              "precision", "sizes", "qtuple"))
def _decode_fused_packed(coeff_all, *, geom, level, gray,
                         precision, sizes, qtuple):
    """_decode_fused on one concatenated [sum(B_i), 64] coefficient array
    (ONE upload instead of per-component transfers; static `sizes` split,
    compile-time quant tables)."""
    comp_blocks = []
    off = 0
    for n in sizes:
        comp_blocks.append(coeff_all[off : off + n])
        off += n
    qtables = tuple(jnp.asarray(np.array(q, np.int32)) for q in qtuple)
    return _decode_fused.__wrapped__(
        tuple(comp_blocks), qtables, geom=geom, level=level, gray=gray,
        precision=precision)


@functools.partial(jax.jit, static_argnames=("precision",))
def planes_to_rgb(y, cb, cr, *, precision="fast"):
    return C.ycc_to_rgb(y, cb, cr, _dtype(precision))


@functools.partial(jax.jit, static_argnames=("precision",))
def plane_to_gray(y, *, precision="fast"):
    return C.clamp_gray(y, _dtype(precision))


def _decode_entropy_batch(pjs: list[ParsedJpeg]) -> list[list[np.ndarray]]:
    """Entropy-decode a batch of parsed streams, thread-parallel across
    images (the C++ frontend releases the GIL during the ctypes call, so
    N images decode on N cores -- the host analog of the data axis)."""
    if len(pjs) <= 1:
        return [decode_entropy_host(pj) for pj in pjs]
    import concurrent.futures as cf
    import os

    workers = min(len(pjs), os.cpu_count() or 1)
    with cf.ThreadPoolExecutor(workers) as ex:
        return list(ex.map(decode_entropy_host, pjs))


def decode_entropy_host(pj: ParsedJpeg) -> list[np.ndarray]:
    """Host entropy frontend: Huffman decode -> [B, 64] blocks/component.

    Native C++ paths: restart-segment thread-parallel decode when the
    stream has DRI/RSTn; the destuffed branchless-refill serial LUT decode
    otherwise (the referent being the strictly serial bit chain at
    jpezy_decoder.hpp:583-642).  Restart-free single streams are
    irreducibly serial per stream on a narrow host (docs/DESIGN.md section
    5 records the retired speculative-resync experiment); batches decode
    thread-parallel ACROSS images instead.  Numpy LUT decoder as the
    no-native fallback.
    """
    from . import oracle as _o

    hmax, vmax = pj.hmax, pj.vmax
    geos = [
        ComponentGeometry(fc.H, fc.V, hmax, vmax, pj.props.width, pj.props.height)
        for fc in pj.frame_components
    ]
    mcus_x, mcus_y = geos[0].mcus_x, geos[0].mcus_y
    n_mcus = mcus_x * mcus_y

    try:
        from ..runtime import native

        return native.entropy_decode(pj, n_mcus)
    except (ImportError, OSError, RuntimeError):
        pass

    dc_lut = [_o._huff_lut(pj.huff[0][sc.Td]) for sc in pj.scan_components]
    ac_lut = [_o._huff_lut(pj.huff[1][sc.Ta]) for sc in pj.scan_components]
    comp_order = [(i, geos[i].blocks_per_mcu) for i in range(len(pj.scan_components))]
    segments, _ = split_entropy_segments(pj.data, pj.entropy_start)
    out: list[list[np.ndarray]] = [[] for _ in pj.frame_components]
    pred = np.zeros(3, dtype=np.int64)
    n_total = mcus_x * mcus_y
    ri = pj.restart_interval if pj.restart_interval else n_total
    done = 0
    for seg in segments:
        if done >= n_total:
            break
        todo = min(ri, n_total - done)
        br = _o._BitReader(seg)
        _o.decode_segment_blocks(br, todo, comp_order, dc_lut, ac_lut, pred, out)
        done += todo
        pred[:] = 0
    if done < n_total:
        raise ValueError("truncated entropy data")
    return [np.stack(o) for o in out]


def _densify(mask_lo, mask_hi, vals):
    """Sparse coefficient transport -> dense [B, 64] int32 blocks.

    mask_lo/hi: [B] uint32 nonzero masks (natural index j); vals: [B, K]
    int16 nonzero values in index order.  Rank-select via exclusive cumsum +
    a K-way select chain (no gathers)."""
    jlo = jnp.arange(32, dtype=jnp.uint32)[None, :]
    blo = (mask_lo[:, None] >> jlo) & jnp.uint32(1)
    bhi = (mask_hi[:, None] >> jlo) & jnp.uint32(1)
    bits = jnp.concatenate([blo, bhi], axis=1).astype(jnp.int32)  # [B, 64]
    rank = jnp.cumsum(bits, axis=1) - bits
    dense = jnp.zeros(bits.shape, jnp.int32)
    K = vals.shape[1]
    v32 = vals.astype(jnp.int32)
    for k in range(K):
        dense = dense + jnp.where(
            (bits == 1) & (rank == k), v32[:, k : k + 1], 0
        )
    return dense


@functools.partial(jax.jit, static_argnames=(
    "geom", "level", "shapes", "K", "N", "caps", "qtuple"))
def _decode_fused_batch_ycc420(flat, *, geom, level, shapes, K, N, caps,
                               qtuple):
    """Fast-transport batched decode: sparse coefficients in, packed
    native-resolution u8 YCC planes out (single fetch; the C++ runtime
    finishes upsample+color with the reference's double-precision tail).

    flat: ONE uint8 buffer.  First N*X bytes are per-image rows holding,
    per component, mask_lo [N,B] u32 | mask_hi [N,B] u32 | vals [N,B,K]
    INT8 (blocks with wider coefficients travel whole in the overflow
    rows); then, per component, the overflow data oidx [cap] i32 | orows
    [cap, 64] i16.  ONE host->device transfer total instead of the ten
    (packed + 3x2 overflow arrays + 3 quant tables) an unpacked layout
    needs, each of which pays a fixed per-transfer cost.
    shapes: tuple of per-component block counts B_i; caps: per-component
    overflow bucket sizes (padding uses the out-of-bounds sentinel N*B_i so
    mode="drop" discards it); qtuple: quant tables as nested int tuples --
    static, so they fold into the executable as constants instead of
    being re-uploaded per batch.
    Note: planes are clamped to u8 BEFORE color conversion; the reference
    clamps after, so IDCT overshoot pixels can differ slightly -- this is
    the documented fast-transport tradeoff (exact mode uses RGB transport).
    """
    X = sum((4 + 4 + K) * Bn for Bn in shapes)
    packed = flat[: N * X].reshape(N, X)
    ooff = N * X
    outs = []
    off = 0
    for Bn, cap, qt, (mcus_y, mcus_x, v, h, _, _) in zip(
        shapes, caps, qtuple, geom
    ):
        ml = jax.lax.bitcast_convert_type(
            packed[:, off : off + 4 * Bn].reshape(N, Bn, 4), jnp.uint32)
        off += 4 * Bn
        mh = jax.lax.bitcast_convert_type(
            packed[:, off : off + 4 * Bn].reshape(N, Bn, 4), jnp.uint32)
        off += 4 * Bn
        vv = jax.lax.bitcast_convert_type(
            packed[:, off : off + Bn * K].reshape(N, Bn, K), jnp.int8)
        off += Bn * K
        dense = _densify(ml.reshape(-1), mh.reshape(-1),
                         vv.reshape(N * Bn, K))
        if cap:
            oidx = jax.lax.bitcast_convert_type(
                flat[ooff : ooff + 4 * cap].reshape(cap, 4), jnp.int32)
            ooff += 4 * cap
            orows = jax.lax.bitcast_convert_type(
                flat[ooff : ooff + 128 * cap].reshape(cap, 64, 2), jnp.int16)
            ooff += 128 * cap
            dense = dense.at[oidx].set(orows.astype(jnp.int32), mode="drop")
        deq = Q.dequantize(dense, jnp.asarray(np.array(qt, np.int32)))
        spat = D.inverse_dct(deq, level, jnp.float32).reshape(N, Bn, 64)
        b6 = spat.reshape(N, mcus_y, mcus_x, v, h, 8, 8)
        plane = b6.transpose(0, 1, 3, 5, 2, 4, 6).reshape(
            N, mcus_y * v * 8, mcus_x * h * 8
        )
        outs.append(
            jnp.clip(plane, 0, 255).astype(jnp.uint8).reshape(N, -1)
        )
    return jnp.concatenate(outs, axis=1)  # [N, H*W * 1.5] for 4:2:0


@functools.partial(jax.jit, static_argnames=(
    "N", "nseg", "ri", "geom", "level"))
def _decode_fused_batch_device(words, nblk, lut, tsel, rawlen, qarr,
                               skip0=None, preds0=None, *, N, nseg,
                               ri, geom, level):
    """FULL device decode for restart-interval 4:2:0 streams: raw destuffed
    entropy bytes in, packed native-resolution u8 YCC planes out.

    The Huffman frontend itself runs on device (ops.entropy_decode:
    segment-lockstep scan), so the upload is ~0.07 B/px of entropy bytes
    instead of ~0.6 B/px of sparse coefficients -- the decode analog of the
    encoder's on-device stream concat (VERDICT r3 #3; referent: the serial
    chain jpezy_decoder.hpp:583-642).
    words: [N*nseg, Lw] uint32 BE segment matrix; nblk: [N*nseg] int32;
    lut: [T, 6, 65536] (or chain tables) with tsel [N*nseg] selecting each
    lane's table set (per-image DHT tables, VERDICT r4 #3); rawlen:
    [N*nseg] destuffed byte lengths feeding the corruption check (VERDICT
    r4 #4); qarr: [N, 3, 64] int32 PER-IMAGE quant tables (traced, so
    mixed-quality batches share one executable and quality changes don't
    recompile).
    Output layout = _decode_fused_batch_ycc420 plus ONE trailing bad-flag
    byte per image (still a single fetch; the C++ runtime finishes
    upsample+color after _decode_batch_device_finish validates the flags).
    """
    from ..ops.entropy_decode import decode_segments

    with jax.named_scope("huffman_scan"):
        blocks, bad = decode_segments(words, nblk, lut, tsel, rawlen,
                                      skip0, preds0, max_blocks=ri * 6)
    mcus_y, mcus_x = geom[0][0], geom[0][1]
    nmcu = mcus_y * mcus_x
    b6 = blocks.reshape(N, nseg * ri, 6, 64)[:, :nmcu]
    comps = (
        b6[:, :, :4].reshape(N, nmcu * 4, 64),   # MCU-raster (v,h) order ==
        b6[:, :, 4],                             # the deblockify layout
        b6[:, :, 5],
    )
    outs = []
    for c, (cb, (my, mx, v, h, _, _)) in enumerate(zip(comps, geom)):
        Bn = cb.shape[1]
        deq = cb.astype(jnp.int32) * qarr[:, c][:, None, :]
        spat = D.inverse_dct(deq.reshape(-1, 64), level,
                             jnp.float32).reshape(N, Bn, 64)
        plane = spat.reshape(N, my, mx, v, h, 8, 8).transpose(
            0, 1, 3, 5, 2, 4, 6).reshape(N, my * v * 8, mx * h * 8)
        outs.append(jnp.clip(plane, 0, 255).astype(jnp.uint8).reshape(N, -1))
    badimg = jnp.any(bad.reshape(N, nseg), axis=1).astype(jnp.uint8)
    return jnp.concatenate(outs + [badimg[:, None]], axis=1)


def _device_host_frontend(pjs, nmcu: int, ri: int, nseg: int):
    """Host half of the device transport: restart offsets + per-segment
    destuff (C++, multithreaded) -> ([S, Lw] BE uint32 rows, [S] block
    counts, [S] destuffed byte lengths for the corruption check).  Split
    out for bench stage attribution (VERDICT r3 #4)."""
    from ..runtime import native

    N = len(pjs)
    datas = [np.frombuffer(pj.data, np.uint8)[pj.entropy_start:]
             for pj in pjs]
    offs = [native.find_restart_offsets(d, nmcu, ri) for d in datas]
    # row stride: max raw segment length + margin (peek reads <= 4 bytes
    # past the final bit), bucketed so jit shapes are stable across batches
    raw_max = 0
    for d, of in zip(datas, offs):
        ends = np.append(of[1:], len(d))
        raw_max = max(raw_max, int((ends - of).max()))
    L = 64
    while L < raw_max + 8:
        L *= 2
    rows = np.zeros((N * nseg, L), np.uint8)
    lens = np.zeros(N * nseg, np.int64)
    for i, (d, of) in enumerate(zip(datas, offs)):
        native.destuff_segments(d, of, rows[i * nseg: (i + 1) * nseg],
                                lens[i * nseg: (i + 1) * nseg])
    words = rows.view(">u4").astype("=u4")         # [S, L/4] BE-packed
    nblk = np.minimum(ri, nmcu - np.arange(nseg) * ri) * 6
    nblk = np.tile(nblk.astype(np.int32), N)
    return words, nblk, lens.astype(np.int32)


def _device_luts(pjs, nseg: int):
    """Per-image decode LUTs, deduplicated by table content: [T, 6, 65536]
    stacked sets + a per-lane table index [N*nseg] (VERDICT r4 #3: foreign
    restart streams and our own optimize=True output carry arbitrary DHT
    tables; the reference decodes any assignment,
    jpezy_decoder.hpp:190-256)."""
    from ..ops.entropy_decode import (build_decode_chain_tables,
                                      build_decode_lut, lut_content_key,
                                      scan_mode)

    build = (build_decode_chain_tables if scan_mode() == "chain"
             else build_decode_lut)
    keys: dict[bytes, int] = {}
    luts = []
    tsel_img = np.empty(len(pjs), np.int32)
    for i, pj in enumerate(pjs):
        k = lut_content_key(pj.huff, pj.scan_components)
        if k not in keys:
            keys[k] = len(luts)
            luts.append(build(pj.huff, pj.scan_components))
        tsel_img[i] = keys[k]
    return np.stack(luts), np.repeat(tsel_img, nseg)


def _decode_batch_indexed_dispatch(pjs, p0, geos, mcus_x, mcus_y, level,
                                   k_mcus: int = 8):
    """Index-assisted two-pass decode of RESTART-FREE streams (SURVEY 2.7
    option (b), the standard GPU-JPEG shape): a serial host LENGTH-ONLY
    scan (C++ jz_index_scan) records every k_mcus MCUs the bit offset and
    absolute DC predictors, then ALL pseudo-segments decode in parallel on
    device via the same lockstep scan as the restart transport (per-lane
    skip0 bit phase + preds0 injection).  The serial dependency of the
    reference's hot loop (jpezy_decoder.hpp:583-642) collapses to the
    cheap pass-1 walk; the upload is raw entropy bytes, like
    transport='device'.
    """
    from ..ops.entropy_decode import device_lut

    if p0.restart_interval:
        raise ValueError("transport='indexed' is for restart-FREE streams"
                         " (restart streams use transport='device')")
    N = len(pjs)
    nmcu = mcus_x * mcus_y
    nseg = -(-nmcu // k_mcus)
    words, nblk, skip0, preds0 = _indexed_host_frontend(pjs, nmcu, k_mcus)
    lut, tsel = _device_luts(pjs, nseg)
    geom = tuple(
        (mcus_y, mcus_x, fc.V, fc.H, geos[i].dup_y, geos[i].dup_x)
        for i, fc in enumerate(p0.frame_components)
    )
    packed = _decode_fused_batch_device(
        jnp.asarray(words), jnp.asarray(nblk), device_lut(lut),
        jnp.asarray(tsel), None, jnp.asarray(_quant_arr(pjs)),
        jnp.asarray(skip0), jnp.asarray(preds0),
        N=N, nseg=nseg, ri=k_mcus, geom=geom, level=level,
    )
    return ("device", packed, p0.props, N, mcus_x, mcus_y)


def _indexed_host_frontend(pjs, nmcu: int, k_mcus: int):
    """Host half of the indexed transport: the C++ length-only index scan
    of each stream (thread-parallel across images) -> ([N*nseg, Lw] BE
    uint32 pseudo-segment rows, [N*nseg] block counts, [N*nseg] start bit
    phases, [N*nseg, 3] absolute DC predictors)."""
    from ..runtime import native

    native.get_lib()
    N = len(pjs)
    nseg = -(-nmcu // k_mcus)

    def _p1(pj):
        return native.index_scan(pj, nmcu, k_mcus)

    if N > 1:
        import concurrent.futures as cf
        import os as _os

        with cf.ThreadPoolExecutor(min(N, _os.cpu_count() or 1)) as ex:
            outs = list(ex.map(_p1, pjs))
    else:
        outs = [_p1(pjs[0])]

    need = 0
    for destuffed, bitoffs, _ in outs:
        ends = np.append((bitoffs[1:] >> 3) + 8, len(destuffed))
        need = max(need, int((ends - (bitoffs >> 3)).max()))
    L = 64
    while L < need + 8:
        L *= 2
    rows = np.zeros((N * nseg, L), np.uint8)
    skip0 = np.zeros(N * nseg, np.int32)
    preds0 = np.zeros((N * nseg, 3), np.int32)
    for i, (destuffed, bitoffs, preds) in enumerate(outs):
        native.copy_bit_windows(destuffed, bitoffs,
                                rows[i * nseg: (i + 1) * nseg])
        skip0[i * nseg: (i + 1) * nseg] = (bitoffs & 7)
        preds0[i * nseg: (i + 1) * nseg] = preds
    words = rows.view(">u4").astype("=u4")
    nblk = np.tile(
        (np.minimum(k_mcus, nmcu - np.arange(nseg) * k_mcus) * 6)
        .astype(np.int32), N)
    return words, nblk, skip0, preds0


def _quant_arr(pjs) -> np.ndarray:
    """[N, 3, 64] int32 per-image quant tables (device dequant input)."""
    return np.stack([
        np.stack([np.asarray(pj.quant[fc.Tq], np.int32)
                  for fc in pj.frame_components])
        for pj in pjs])


def _decode_batch_device_dispatch(pjs, p0, geos, mcus_x, mcus_y, level):
    """Host prep for the full device decode (transport='device'): find
    restart offsets, destuff segments into a [S, L] matrix (C++,
    multithreaded), ONE upload of big-endian words + per-lane block counts
    + destuffed lengths.  Requires: every stream shares p0's
    restart_interval; Huffman AND quant tables may differ per image
    (deduplicated LUT sets + per-lane select; traced [N, 3, 64] quant)."""
    from ..ops.entropy_decode import device_lut
    from ..runtime import native

    native.get_lib()
    ri = p0.restart_interval
    if ri <= 0:
        raise ValueError("transport='device' needs restart-interval streams")
    for pj in pjs[1:]:
        if pj.restart_interval != ri:
            raise ValueError("transport='device' needs uniform DRI")
    N = len(pjs)
    nmcu = mcus_x * mcus_y
    nseg = -(-nmcu // ri)
    words, nblk, rawlen = _device_host_frontend(pjs, nmcu, ri, nseg)
    lut, tsel = _device_luts(pjs, nseg)
    geom = tuple(
        (mcus_y, mcus_x, fc.V, fc.H, geos[i].dup_y, geos[i].dup_x)
        for i, fc in enumerate(p0.frame_components)
    )
    packed = _decode_fused_batch_device(
        jnp.asarray(words), jnp.asarray(nblk), device_lut(lut),
        jnp.asarray(tsel), jnp.asarray(rawlen),
        jnp.asarray(_quant_arr(pjs)),
        N=N, nseg=nseg, ri=ri, geom=geom, level=level,
    )
    # ycc420 layout + one bad-flag byte per image (_decode_batch_device_finish)
    return ("device", packed, p0.props, N, mcus_x, mcus_y)


@functools.partial(jax.jit, static_argnames=(
    "geom", "level", "gray", "precision", "sizes", "qtuple"))
def _decode_fused_batch_packed(coeff_all, *, geom, level, gray, precision,
                               sizes, qtuple):
    """_decode_fused_batch on one concatenated [N, sum(B_i), 64] coefficient
    array with compile-time quant tables: ONE upload instead of
    3 coefficient + 3 table transfers."""
    comp_blocks = []
    off = 0
    for n in sizes:
        comp_blocks.append(coeff_all[:, off : off + n])
        off += n
    qtables = tuple(jnp.asarray(np.array(q, np.int32)) for q in qtuple)
    return _decode_fused_batch.__wrapped__(
        tuple(comp_blocks), qtables, geom=geom, level=level, gray=gray,
        precision=precision)


@functools.partial(jax.jit, static_argnames=("geom", "level", "gray", "precision"))
def _decode_fused_batch(comp_blocks, qtables, *, geom, level, gray, precision):
    """Batched _decode_fused: comp_blocks are [N, B_i, 64] per component."""
    dt = _dtype(precision)
    planes = []
    for cb, qt, (mcus_y, mcus_x, v, h, dup_y, dup_x) in zip(
        comp_blocks, qtables, geom
    ):
        N, Bn, _ = cb.shape
        deq = Q.dequantize(cb.reshape(-1, 64), qt)
        spat = D.inverse_dct(deq, level, dt).reshape(N, Bn, 64)
        b6 = spat.reshape(N, mcus_y, mcus_x, v, h, 8, 8)
        plane = b6.transpose(0, 1, 3, 5, 2, 4, 6).reshape(
            N, mcus_y * v * 8, mcus_x * h * 8
        )
        if dup_y > 1 or dup_x > 1:
            plane = jnp.repeat(jnp.repeat(plane, dup_y, axis=1), dup_x, axis=2)
        planes.append(plane)
    if gray or len(planes) == 1:
        return C.clamp_gray(planes[0], dt)[..., None]
    r, g, b = C.ycc_to_rgb(planes[0], planes[1], planes[2], dt)
    return jnp.stack([r, g, b], axis=-1)


def decode_batch_dispatch(streams: list[bytes], *, gray: bool = False,
                          precision: str = "fast",
                          transport: str | None = None):
    """Host-side decode work + async device dispatch for a uniform batch.

    Runs the marker parse, entropy frontend (host C++/numpy), coefficient
    upload and the jitted device backend dispatch, returning an opaque
    ticket for decode_batch_finish.  The device program and the result
    transfer proceed in the background (see runtime/pipeline.py)."""
    pjs = [parse(s) for s in streams]
    p0 = pjs[0]
    for pj in pjs[1:]:
        if (pj.props.width, pj.props.height) != (p0.props.width, p0.props.height) \
           or len(pj.frame_components) != len(p0.frame_components):
            raise ValueError("decode_batch needs uniform stream geometry")
    hmax, vmax = p0.hmax, p0.vmax
    geos = [
        ComponentGeometry(fc.H, fc.V, hmax, vmax, p0.props.width, p0.props.height)
        for fc in p0.frame_components
    ]
    mcus_x, mcus_y = geos[0].mcus_x, geos[0].mcus_y
    level = 128 if p0.props.sample_precision == 8 else 2048
    ncomp = len(p0.frame_components)

    std420 = (
        ncomp == 3
        and [(fc.H, fc.V) for fc in p0.frame_components] == [(2, 2), (1, 1), (1, 1)]
    )
    auto = transport is None
    if auto:
        transport = "ycc420" if (precision == "fast" and std420 and not gray) \
            else "rgb"
    if transport == "indexed":
        # index-assisted two-pass decode of restart-free streams (opt-in;
        # see _decode_batch_indexed_dispatch and DESIGN.md section 5c)
        if not (std420 and not gray and precision == "fast"):
            raise ValueError(
                "transport='indexed' supports fast-precision standard "
                "4:2:0 color streams only")
        return _decode_batch_indexed_dispatch(
            pjs, p0, geos, mcus_x, mcus_y, level)
    if transport == "device" or (auto and transport == "ycc420"
                                 and p0.restart_interval > 0):
        # restart streams auto-pick the full device decode (identical
        # pixels to ycc420, ~7x less upload, Huffman off the host); auto
        # mode falls back on any ineligibility, explicit mode raises
        if not (std420 and not gray and precision == "fast"):
            raise ValueError(
                "transport='device' supports fast-precision standard 4:2:0 "
                "color streams only")
        try:
            return _decode_batch_device_dispatch(
                pjs, p0, geos, mcus_x, mcus_y, level)
        except (ImportError, ValueError):
            if not auto:
                raise
            # fall through to the ycc420 transport
    if transport == "ycc420" and std420 and not gray:
        try:
            return _decode_batch_ycc420_dispatch(
                pjs, p0, geos, mcus_x, mcus_y, level)
        except ImportError:
            pass  # no native runtime: fall through to rgb transport

    _check_uniform_quant(pjs, p0)
    per_image = _decode_entropy_batch(pjs)
    sizes = tuple(int(per_image[0][c].shape[0]) for c in range(ncomp))
    dt0 = np.result_type(*[cb.dtype for cb in per_image[0]])
    coeff_all = np.concatenate(
        [np.stack([np.asarray(pi[c], dt0) for pi in per_image])
         for c in range(ncomp)], axis=1)
    geom = tuple(
        (mcus_y, mcus_x, fc.V, fc.H, geos[i].dup_y, geos[i].dup_x)
        for i, fc in enumerate(p0.frame_components)
    )
    qtuple = tuple(
        tuple(int(x) for x in p0.quant[fc.Tq])
        for fc in p0.frame_components
    )
    out = _decode_fused_batch_packed(
        jnp.asarray(coeff_all), geom=geom, level=level,
        gray=gray or ncomp == 1, precision=precision, sizes=sizes,
        qtuple=qtuple,
    )
    return ("rgb", out, p0.props)


def decode_batch_finish(ticket) -> tuple[np.ndarray, ImageProps]:
    """Block on a dispatched batch decode and return ([N,H,W,3] u8, props)."""
    kind = ticket[0]
    if kind == "device":
        return _decode_batch_device_finish(ticket)
    if kind == "ycc420":
        return _decode_batch_ycc420_finish(ticket)
    _, out, props = ticket
    out = np.asarray(out)  # ONE fetch for the whole batch
    H, W = props.height, props.width
    out = out[:, :H, :W]
    if out.shape[-1] == 1:
        out = np.repeat(out, 3, axis=-1)
    return out, props


def decode_batch(streams: list[bytes], *, gray: bool = False,
                 precision: str = "fast",
                 transport: str | None = None) -> tuple[np.ndarray, ImageProps]:
    """Decode a batch of same-geometry JPEGs -> ([N, H, W, 3] uint8, props).

    All streams must share dimensions/sampling/tables geometry (e.g. the
    output of encode_batch); raises ValueError otherwise.

    transport: "rgb" fetches full interleaved RGB from the device (exactly
    the reference's semantics); "ycc420" uploads sparse coefficients and
    fetches native-resolution u8 planes (~3.5x less link traffic), with the
    final upsample+color done by the C++ runtime -- IDCT overshoot pixels
    differ vs the reference because planes clamp before color conversion
    (measured envelope on adversarial saturated-checkerboard content:
    max 53 LSB on 3.4%% of pixels, PSNR-vs-source delta 0.003 dB --
    test_jax_codec.py::TestYcc420ClampEnvelope pins it).  Default: ycc420
    for precision='fast' on standard 4:2:0 color streams, rgb otherwise.
    """
    return decode_batch_finish(decode_batch_dispatch(
        streams, gray=gray, precision=precision, transport=transport))


# _check_decodable lives in bitstream.reader (shared with codec.host_codec)


def _ycc420_host_frontend(pjs, K: int = 10):
    """Host half of the ycc420 transport: entropy decode + sparsify per
    image, thread-parallel, -> ONE flat uint8 upload buffer + static metas.

    Split out so the bench can attribute frontend / upload / device / fetch
    separately (VERDICT r3 #4)."""
    from ..runtime import native

    native.get_lib()  # raise ImportError-family early if unavailable
    N = len(pjs)

    # entropy decode + sparsify per image, thread-parallel (both stages are
    # GIL-releasing C++ calls; images are independent)
    def _front(pj):
        blocks = decode_entropy_host(pj)
        return blocks, [native.sparsify8(b, K) for b in blocks]

    if N > 1:
        import concurrent.futures as cf
        import os as _os

        with cf.ThreadPoolExecutor(min(N, _os.cpu_count() or 1)) as ex:
            fronts = list(ex.map(_front, pjs))
    else:
        fronts = [_front(pjs[0])]

    # ONE uint8 upload buffer: per-image rows (per comp mask_lo | mask_hi |
    # vals), then per-comp overflow tails (see _decode_fused_batch_ycc420)
    shapes = tuple(fronts[0][0][c].shape[0] for c in range(3))
    pieces = []
    tails = []
    caps = []
    for c in range(3):
        Bn = shapes[c]
        mls, mhs, vvs, oidx_all, orows_all = [], [], [], [], []
        for i, (_, sp) in enumerate(fronts):
            ml, mh, vv, oidx, orows = sp[c]
            mls.append(ml); mhs.append(mh); vvs.append(vv)
            oidx_all.append(oidx + i * Bn)
            orows_all.append(orows)
        pieces.append(np.stack(mls).view(np.uint8).reshape(N, -1))
        pieces.append(np.stack(mhs).view(np.uint8).reshape(N, -1))
        pieces.append(np.stack(vvs).view(np.uint8).reshape(N, -1))
        oi = np.concatenate(oidx_all).astype(np.int32)
        orw = (np.concatenate(orows_all) if oidx_all
               else np.zeros((0, 64), np.int16))
        # pad to a bucket so jit shapes stay stable across batches; the
        # sentinel must be OUT OF BOUNDS (>= N*Bn) so mode="drop" discards
        # it -- a negative index would WRAP to a real block (ADVICE r2)
        cap = max(16, 1 << (len(oi) - 1).bit_length()) if len(oi) else 0
        if cap:
            oi = np.concatenate(
                [oi, np.full(cap - len(oi), N * Bn, np.int32)])
            orw = np.concatenate(
                [orw, np.zeros((cap - orw.shape[0], 64), np.int16)])
            tails.append(oi.view(np.uint8).reshape(-1))
            tails.append(orw.view(np.uint8).reshape(-1))
        caps.append(cap)

    flat_host = np.concatenate(
        [np.concatenate(pieces, axis=1).reshape(-1)] + tails)
    return flat_host, shapes, tuple(caps)


def _check_uniform_quant(pjs, p0) -> None:
    """The host-frontend transports dequantize every image with p0's
    tables; a mixed-quality batch would silently decode garbage.  (The
    device transport carries per-image quant and has no such limit.)"""
    for pj in pjs[1:]:
        for fc, fc0 in zip(pj.frame_components, p0.frame_components):
            if not np.array_equal(pj.quant[fc.Tq], p0.quant[fc0.Tq]):
                raise ValueError(
                    "decode_batch needs uniform quant tables on this "
                    "transport (mixed-quality batches decode on "
                    "transport='device'/'indexed')")


def _decode_batch_ycc420_dispatch(pjs, p0, geos, mcus_x, mcus_y, level):
    """Sparse-upload / planar-download fast transport (see decode_batch)."""
    _check_uniform_quant(pjs, p0)
    K = 10
    N = len(pjs)
    flat_host, shapes, caps = _ycc420_host_frontend(pjs, K)
    geom = tuple(
        (mcus_y, mcus_x, fc.V, fc.H, geos[i].dup_y, geos[i].dup_x)
        for i, fc in enumerate(p0.frame_components)
    )
    qtuple = tuple(
        tuple(int(x) for x in p0.quant[fc.Tq])
        for fc in p0.frame_components
    )
    packed = _decode_fused_batch_ycc420(
        jnp.asarray(flat_host), geom=geom, level=level, shapes=shapes,
        K=K, N=N, caps=caps, qtuple=qtuple,
    )
    return ("ycc420", packed, p0.props, N, mcus_x, mcus_y)


def _decode_batch_device_finish(ticket):
    """Validate the per-image corruption flags the device scan appended,
    then reuse the ycc420 color tail.  The reference propagates decode
    failure as an empty optional (jpezy_decoder.hpp:593,635 -> 109-120);
    our host paths raise -- so does the device transport (VERDICT r4 #4)."""
    _, packed, props, N, mcus_x, mcus_y = ticket
    packed = np.asarray(packed)  # ONE fetch (planes + flags)
    bad = packed[:, -1]
    if bad.any():
        raise ValueError(
            "corrupt entropy data in stream(s) "
            f"{np.nonzero(bad)[0].tolist()} (device Huffman scan)")
    return _decode_batch_ycc420_finish(
        ("ycc420", packed[:, :-1], props, N, mcus_x, mcus_y))


def _decode_batch_ycc420_finish(ticket):
    from ..runtime import native

    _, packed, props, N, mcus_x, mcus_y = ticket
    packed = np.asarray(packed)  # ONE fetch
    H, W = props.height, props.width
    Hm, Wm = mcus_y * 16, mcus_x * 16
    ny = Hm * Wm
    nc = (Hm // 2) * (Wm // 2)
    # multithreaded batch color tail on the padded planes, crop after
    # (the pad is <= 15 px per axis; the chroma indexing is identical
    # because Hm, Wm are even and the crop only drops rows/cols)
    ys = packed[:, :ny].reshape(N, Hm, Wm)
    cbs = packed[:, ny : ny + nc].reshape(N, Hm // 2, Wm // 2)
    crs = packed[:, ny + nc :].reshape(N, Hm // 2, Wm // 2)
    out = native.ycc420_to_rgb_batch(ys, cbs, crs)[:, :H, :W]
    return out, props


def decode(data: bytes, *, gray: bool = False, precision: str = "fast",
           verbose: bool = False, transport: str | None = None):
    """Decode baseline JPEG bytes -> (r, g, b [H, W] uint8, ImageProps).

    verbose: per-phase section timers on stdout, the decoder<Debug> analog
    (the reference allocates raii_messengers inside its decode phases,
    jpezy_decoder.hpp:90-92,173-175,192-193).

    transport: same choices and default policy as decode_batch (VERDICT r3
    #2: the single-image path carries the batch-grade transports at N=1) --
    "ycc420" uploads sparse int8 coefficients and fetches native-resolution
    u8 planes with the C++ color tail; "rgb" is the reference-semantics
    full-RGB fetch.  Default: ycc420 for precision='fast' standard 4:2:0
    color streams, rgb otherwise."""
    import contextlib

    from ..utils.timing import SectionTimer

    phase = (lambda msg: SectionTimer(msg, indent="\t")) if verbose \
        else (lambda msg: contextlib.nullcontext())

    with phase("analyzing header..."):
        pj = parse(data)
        _check_decodable(pj)
    props = pj.props
    hmax, vmax = pj.hmax, pj.vmax
    geos = [
        ComponentGeometry(fc.H, fc.V, hmax, vmax, props.width, props.height)
        for fc in pj.frame_components
    ]
    mcus_x, mcus_y = geos[0].mcus_x, geos[0].mcus_y
    level = 128 if props.sample_precision == 8 else 2048

    std420 = (
        len(pj.frame_components) == 3
        and [(fc.H, fc.V) for fc in pj.frame_components]
        == [(2, 2), (1, 1), (1, 1)]
    )
    auto = transport is None
    if auto:
        transport = "ycc420" if (precision == "fast" and std420
                                 and not gray) else "rgb"
        if transport == "ycc420" and pj.restart_interval > 0:
            transport = "device"   # identical pixels, ~7x less upload
    if transport in ("ycc420", "device", "indexed") and std420 and not gray:
        try:
            with phase("entropy frontend + sparse upload (dispatch)..."):
                try:
                    dispatch = {
                        "device": _decode_batch_device_dispatch,
                        "indexed": _decode_batch_indexed_dispatch,
                        "ycc420": _decode_batch_ycc420_dispatch,
                    }[transport]
                    ticket = dispatch([pj], pj, geos, mcus_x, mcus_y, level)
                except (ImportError, ValueError):
                    if not auto or transport != "device":
                        raise
                    # auto device pick ineligible: use the sparse transport
                    ticket = _decode_batch_ycc420_dispatch(
                        [pj], pj, geos, mcus_x, mcus_y, level)
            with phase("device backend + fetch + color tail..."):
                out, _ = decode_batch_finish(ticket)
            out = out[0]
            return out[..., 0], out[..., 1], out[..., 2], props
        except ImportError:
            pass  # no native runtime: fall through to rgb transport

    with phase("decoding huffman (entropy frontend)..."):
        comp_blocks = decode_entropy_host(pj)
    ncomp = len(pj.frame_components)
    geom = tuple(
        (mcus_y, mcus_x, fc.V, fc.H, geos[i].dup_y, geos[i].dup_x)
        for i, fc in enumerate(pj.frame_components)
    )
    sizes = tuple(int(cb.shape[0]) for cb in comp_blocks)
    dt0 = np.result_type(*[cb.dtype for cb in comp_blocks])
    qtuple = tuple(
        tuple(int(x) for x in pj.quant[fc.Tq])
        for fc in pj.frame_components
    )
    with phase("dequant + inverse DCT + color (device)..."):
        out = _decode_fused_packed(
            jnp.asarray(np.concatenate(
                [np.asarray(cb, dt0) for cb in comp_blocks])),
            geom=geom, level=level, gray=gray or ncomp == 1,
            precision=precision, sizes=sizes, qtuple=qtuple,
        )
        out = np.asarray(out)  # ONE fetch
    H, W = props.height, props.width
    out = out[:H, :W]
    if out.shape[-1] == 1:
        gv = out[..., 0]
        return gv, gv.copy(), gv.copy(), props
    return out[..., 0], out[..., 1], out[..., 2], props
