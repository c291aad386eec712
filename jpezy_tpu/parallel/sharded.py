"""Mesh-sharded codec pipelines (shard_map over a ('data', 'tile') mesh).

Everything in the codec is block-local except two sequential dependencies
(SURVEY.md section 2.7):

  - the per-component DC predictor chain on encode: handled by exchanging one
    carry value per component between neighboring 'tile' shards with a single
    `ppermute` (shard k's first predictor = shard k-1's last DC);
  - the entropy bit cursor: per-shard bitstrings are packed independently on
    device and spliced on the host (byte-granular work).

Sharding layout: images over 'data' (no collectives), contiguous MCU-row
ranges of each image over 'tile'.  Cards joined all to all (NVLink) need
no particular device order; across hosts, keep 'tile' within a host so the
carry ppermute stays off the network.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from ..ops import blocks as B
from ..ops import colorspace as C
from ..ops import dct as D
from ..ops import entropy as E
from ..ops import quantize as Q


def _encode_local(r, g, b, *, gray: bool, dtype, rounded: bool, tile_axis: str | None,
                  qtables=None, restart_interval: int = 0):
    """Encode the local shard: [N_loc, H_loc, W] planes -> (words, bits).

    H_loc must be a multiple of 16 (whole MCU rows per shard).
    """
    y, cb, cr = C.rgb_to_ycc(r, g, b, dtype)
    cb = jax.vmap(B.decimate_420)(cb)
    cr = jax.vmap(B.decimate_420)(cr)
    return _encode_local_ycc(
        y, cb, cr, gray=gray, dtype=dtype, rounded=rounded,
        tile_axis=tile_axis, qtables=qtables,
        restart_interval=restart_interval,
    )


def _encode_local_ycc(y, cb, cr, *, gray: bool, dtype, rounded: bool,
                      tile_axis: str | None,
                      qtables=None, restart_interval: int = 0,
                      interleave: bool = True):
    """Encode from level-shifted YCC planes (chroma already 4:2:0 decimated).

    y: [N_loc, H_loc, W] int (Y-128); cb/cr: [N_loc, H_loc/2, W/2] int.
    Entry point for the host-converted int8 upload transport (half the
    link bytes of RGB; see codec.jax_codec.host_rgb_to_ycc420).
    interleave=False returns per-component (words, bits) tuples instead
    of MCU-interleaved arrays (see _emit_local).
    """
    yq, cbq, crq = _quantize_local_ycc(
        y, cb, cr, gray=gray, dtype=dtype, rounded=rounded, qtables=qtables)
    return _emit_local(yq, cbq, crq, tile_axis=tile_axis,
                       restart_interval=restart_interval,
                       interleave=interleave)


def _quantize_local_ycc(y, cb, cr, *, gray: bool, dtype, rounded: bool,
                        qtables=None):
    """YCC planes -> per-component quantized blocks [N_loc, B_loc, 64].

    qtables: optional (yqt, cqt) quant tables (quality-scaled extension);
    None = the fixed Annex K tables."""
    yqt, cqt = qtables if qtables is not None else (None, None)
    yb = jax.vmap(B.blockify_luma)(y)
    cbb = jax.vmap(B.blockify_chroma)(cb)
    crb = jax.vmap(B.blockify_chroma)(cr)
    if gray:
        cbb = jnp.zeros_like(cbb)
        crb = jnp.zeros_like(crb)
    out = []
    for blk, chroma, qt in ((yb, False, yqt), (cbb, True, cqt),
                            (crb, True, cqt)):
        n_loc, b_loc, _ = blk.shape
        out.append(Q.quantize(
            D.forward_dct(blk.reshape(-1, 64), dtype), chroma,
            rounded=rounded, qtable=qt,
        ).reshape(n_loc, b_loc, 64))
    return tuple(out)


def _emit_local(yq, cbq, crq, *, tile_axis: str | None, tables=(None, None),
                restart_interval: int = 0, interleave: bool = True):
    """Quantized blocks -> (words, bits), with the DC-carry ppermute when
    tile-sharded.  tables: optional (ytables, ctables) custom flat Huffman
    tables (see ops.entropy.block_emissions).

    restart_interval > 0 resets the DC predictor chains every that many
    MCUs (T.81 F.2.1.3.1).  Under tile sharding the caller must align
    segments with shard boundaries (mcus_per_shard % restart_interval == 0)
    so the local block index is congruent to the global one mod the
    segment length."""
    ems = []
    for q, chroma, tabs, bpm in (
            (yq, False, tables[0], 4), (cbq, True, tables[1], 1),
            (crq, True, tables[1], 1)):
        n_loc, b_loc, _ = q.shape
        dc = q[:, :, 0]
        if tile_axis is not None:
            axis_size = jax.lax.axis_size(tile_axis)
            # carry: previous shard's last DC is this shard's first predictor
            prev = jax.lax.ppermute(
                dc[:, -1], tile_axis, [(i, i + 1) for i in range(axis_size - 1)]
            )
        else:
            prev = jnp.zeros_like(dc[:, -1])
        pred = jnp.concatenate([prev[:, None], dc[:, :-1]], axis=1)
        if restart_interval > 0:
            seg_blocks = restart_interval * bpm
            idx = jnp.arange(b_loc, dtype=jnp.int32)[None, :]
            pred = jnp.where(idx % seg_blocks == 0, jnp.zeros_like(pred), pred)
        # flatten images into the block axis: emissions are block-local
        # (the DC chain is already captured in `pred`)
        hi, lo, nb = E.block_emissions(
            q.reshape(-1, 64), pred.reshape(-1), chroma, tables=tabs
        )
        ems.append(tuple(x.reshape(n_loc, b_loc, 64) for x in (hi, lo, nb)))

    n_loc = ems[1][0].shape[0]
    nm = ems[1][0].shape[1]
    # pack per component, THEN interleave the packed words to MCU order
    # (Y0..Y3, Cb, Cr): one [B, W] relayout instead of three [B, 64]
    # emission relayouts (the pre-pack interleave cost ~1.4 ms/batch of
    # pure data movement in the r5 stage attribution).  Per-block packed
    # words are order-independent, so the streams are bit-identical.
    packed = []
    for hi, lo, nb in ems:
        w_c, b_c = E.pack_block_words(
            hi.reshape(-1, 64), lo.reshape(-1, 64), nb.reshape(-1, 64))
        packed.append((w_c.reshape(n_loc, -1, w_c.shape[-1]),
                       b_c.reshape(n_loc, -1)))
    if not interleave:
        # COMPONENT-ordered return (jax_codec._encode_batch_blocks_ycc):
        # the stream concat's scatter-add is order-independent, so even
        # the post-pack MCU interleave of the [B, W] words can be skipped
        # -- only the tiny [n, nm*6] bits array is interleaved (for the
        # global bit offsets), and overflow fallbacks reorder on host
        return (tuple(p[0] for p in packed), tuple(p[1] for p in packed))
    W = packed[0][0].shape[-1]
    words = jnp.concatenate(
        [packed[0][0].reshape(n_loc, nm, 4, W),
         packed[1][0].reshape(n_loc, nm, 1, W),
         packed[2][0].reshape(n_loc, nm, 1, W)], axis=2
    ).reshape(n_loc, nm * 6, W)
    bits = jnp.concatenate(
        [packed[0][1].reshape(n_loc, nm, 4),
         packed[1][1].reshape(n_loc, nm, 1),
         packed[2][1].reshape(n_loc, nm, 1)], axis=2
    ).reshape(n_loc, nm * 6)
    return words, bits


@functools.lru_cache(maxsize=64)
def make_sharded_encode(mesh: Mesh, *, gray: bool = False,
                        precision: str = "fast", rounded: bool = False,
                        quality: int | None = None,
                        restart_interval: int = 0):
    """Build a jitted sharded encode step.

    fn(r, g, b): [N, H, W] uint8 (H, W multiples of 16; N divisible by the
    'data' axis; H/16 divisible by the 'tile' axis) ->
    (words [N, nmcu*6, 64] uint32, bits [N, nmcu*6] int32), both sharded
    P('data', 'tile').
    """
    from ..core import tables as T

    dtype = jnp.float64 if precision == "exact" else jnp.float32
    qtables = (T.scale_quant_tables(quality) if quality is not None else None)
    local = functools.partial(
        _encode_local, gray=gray, dtype=dtype, rounded=rounded,
        tile_axis="tile", qtables=qtables,
        restart_interval=restart_interval,
    )
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("data", "tile", None),) * 3,
        out_specs=(P("data", "tile", None), P("data", "tile")),
    )
    return jax.jit(fn)


def _concat_local_combined(words, bits, maxw_shard: int, restart_interval: int):
    """Per-shard device concat -> combined [n_loc, 1, R + maxw] uint32
    (R = 1 total-bits word, plus per-segment bit counts with restarts)."""
    n_loc, b_loc, W = words.shape
    maxw = maxw_shard or max(4096, b_loc * 4)
    if restart_interval > 0:
        stream, total, seg_bits = E.concat_device_restart_batch(
            words, bits, maxw, 6 * restart_interval)
        comb = jnp.concatenate(
            [total[:, None].astype(jnp.uint32),
             seg_bits.astype(jnp.uint32), stream], axis=1)
    else:
        stream, total = E.concat_device_batch(words, bits, maxw)
        comb = jnp.concatenate(
            [total[:, None].astype(jnp.uint32), stream], axis=1)
    return comb[:, None, :]                           # [n_loc, 1(tile), R+maxw]


@functools.lru_cache(maxsize=64)
def make_sharded_encode_stream(mesh: Mesh, *, gray: bool = False,
                               precision: str = "fast", rounded: bool = False,
                               quality: int | None = None,
                               restart_interval: int = 0,
                               maxw_shard: int = 0):
    """Sharded encode with ON-DEVICE per-shard stream concat (one compact
    fetch instead of 64-word padded block buffers; VERDICT r1 #4).

    fn(r, g, b) -> combined [N, tile, R + maxw_shard] uint32 sharded
    P('data', 'tile', None), where R = 1 (the per-shard total bit count)
    plus, with restart_interval, the per-shard segment bit counts.  Each
    tile shard's blocks concatenate into one bitstring on device; the host
    splices the `tile` per-shard strings per image (bitstream.splice) --
    byte-granular work, like the reference's buffered stream flush.

    With restart_interval the caller must keep shard boundaries on segment
    boundaries (mcus_per_shard % restart_interval == 0); each shard's
    stream then holds its whole segments byte-aligned (seg_bits layout of
    ops.entropy.concat_device_restart).
    """
    from ..core import tables as T

    dtype = jnp.float64 if precision == "exact" else jnp.float32
    qtables = (T.scale_quant_tables(quality) if quality is not None else None)

    def local(r, g, b):
        words, bits = _encode_local(
            r, g, b, gray=gray, dtype=dtype, rounded=rounded,
            tile_axis="tile", qtables=qtables,
            restart_interval=restart_interval,
        )
        return _concat_local_combined(words, bits, maxw_shard,
                                      restart_interval)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("data", "tile", None),) * 3,
        out_specs=P("data", "tile", None),
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def make_sharded_quantize(mesh: Mesh, *, gray: bool = False,
                          precision: str = "fast", rounded: bool = False,
                          quality: int | None = None,
                          restart_interval: int = 0):
    """Pass 1 of the sharded two-pass `optimize` encode.

    fn(r, g, b) -> (yq, cbq, crq sharded P('data','tile',None),
    hists [4,256] replicated): quantized blocks stay device-resident for
    pass 2; the Huffman symbol histograms (psum over both mesh axes) are
    the only fetch.
    """
    from ..core import tables as T

    dtype = jnp.float64 if precision == "exact" else jnp.float32
    qtables = (T.scale_quant_tables(quality) if quality is not None else None)

    def local(r, g, b):
        y, cb, cr = C.rgb_to_ycc(r, g, b, dtype)
        cb = jax.vmap(B.decimate_420)(cb)
        cr = jax.vmap(B.decimate_420)(cr)
        yq, cbq, crq = _quantize_local_ycc(
            y, cb, cr, gray=gray, dtype=dtype, rounded=rounded,
            qtables=qtables)
        hists = []
        for q, bpm in ((yq, 4), (cbq, 1), (crq, 1)):
            n_loc, b_loc, _ = q.shape
            dc = q[:, :, 0]
            axis_size = jax.lax.axis_size("tile")
            prev = jax.lax.ppermute(
                dc[:, -1], "tile", [(i, i + 1) for i in range(axis_size - 1)]
            )
            pred = jnp.concatenate([prev[:, None], dc[:, :-1]], axis=1)
            if restart_interval > 0:
                segb = restart_interval * bpm
                idx = jnp.arange(b_loc, dtype=jnp.int32)[None, :]
                pred = jnp.where(idx % segb == 0, jnp.zeros_like(pred), pred)
            dh, ah = E.symbol_histograms(q.reshape(-1, 64), pred.reshape(-1))
            hists.append((dh, ah))
        stacked = jnp.stack([hists[0][0], hists[0][1],
                             hists[1][0] + hists[2][0],
                             hists[1][1] + hists[2][1]])
        stacked = jax.lax.psum(stacked, ("data", "tile"))
        return yq, cbq, crq, stacked

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("data", "tile", None),) * 3,
        out_specs=(P("data", "tile", None),) * 3 + (P(),),
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def make_sharded_emit_stream(mesh: Mesh, *, restart_interval: int = 0,
                             maxw_shard: int = 0):
    """Pass 2 of the sharded two-pass `optimize` encode: entropy-code the
    device-resident quantized blocks with custom (traced) Huffman tables.

    fn(yq, cbq, crq, ytables, ctables) -> combined, as
    make_sharded_encode_stream.
    """
    def local(yq, cbq, crq, ytables, ctables):
        words, bits = _emit_local(
            yq, cbq, crq, tile_axis="tile",
            tables=(ytables, ctables), restart_interval=restart_interval,
        )
        return _concat_local_combined(words, bits, maxw_shard,
                                      restart_interval)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("data", "tile", None),) * 3 + (P(None), P(None)),
        out_specs=P("data", "tile", None),
    )
    return jax.jit(fn)


def _decode_local(coeff, qtable, *, v, h, dup_y, dup_x, mcus_x, level, dtype):
    """[N_loc, B_loc, 64] absolute-DC coefficient blocks -> local planes."""
    n_loc, b_loc, _ = coeff.shape
    mcus_y_loc = b_loc // (v * h) // mcus_x
    deq = Q.dequantize(coeff.reshape(-1, 64), qtable)
    spat = D.inverse_dct(deq, level, dtype).reshape(n_loc, b_loc, 64)
    plane = jax.vmap(
        lambda s: B.deblockify(s, mcus_y_loc, mcus_x, v, h)
    )(spat)
    return jax.vmap(lambda p: B.upsample_nearest(p, dup_y, dup_x))(plane)


def make_sharded_decode_component(mesh: Mesh, *, v: int, h: int, dup_y: int,
                                  dup_x: int, mcus_x: int, level: int = 128,
                                  precision: str = "fast"):
    """Build a jitted sharded per-component decode backend.

    fn(coeff [N, B, 64] int32 sharded P('data','tile'), qtable [64]) ->
    upsampled planes [N, H_mcu, W_mcu] sharded P('data','tile').
    Block axis sharding = contiguous MCU-row ranges.
    """
    dtype = jnp.float64 if precision == "exact" else jnp.float32
    local = functools.partial(
        _decode_local, v=v, h=h, dup_y=dup_y, dup_x=dup_x,
        mcus_x=mcus_x, level=level, dtype=dtype,
    )
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("data", "tile", None), P(None)),
        out_specs=P("data", "tile", None),
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def make_sharded_decode(mesh: Mesh, *, comps, mcus_x: int, level: int = 128,
                        gray: bool = False, precision: str = "fast"):
    """Build ONE jitted shard_map for the whole decode backend (all
    components fused, single fetch; VERDICT r1 #4 -- the referent is the
    full decode pipeline, jpezy_decoder.hpp:76-134).

    comps: tuple of (v, h, dup_y, dup_x) per component.
    fn(coeffs..., qtables...) with coeffs [N, B_i, 64] int32 sharded
    P('data', 'tile', None) -> uint8 [N, H_mcu, W_mcu, 3] (or [..., 1] for
    gray/1-component) sharded P('data', 'tile', None, None).

    Everything is shard-local: tile shards hold whole MCU rows, and the
    4:2:0 upsample + color conversion only ever read within an MCU row, so
    the fused program needs NO collectives.
    """
    dtype = jnp.float64 if precision == "exact" else jnp.float32
    ncomp = len(comps)

    def local(*args):
        coeffs, qtables = args[:ncomp], args[ncomp:]
        planes = []
        for cb, qt, (v, h, dup_y, dup_x) in zip(coeffs, qtables, comps):
            planes.append(_decode_local(
                cb, qt, v=v, h=h, dup_y=dup_y, dup_x=dup_x,
                mcus_x=mcus_x, level=level, dtype=dtype))
        if gray or ncomp == 1:
            return C.clamp_gray(planes[0], dtype)[..., None]
        r, g, b = C.ycc_to_rgb(planes[0], planes[1], planes[2], dtype)
        return jnp.stack([r, g, b], axis=-1)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=tuple([P("data", "tile", None)] * ncomp + [P(None)] * ncomp),
        out_specs=P("data", "tile", None, None),
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=32)
def make_sharded_decode_device(mesh: Mesh, *, ri: int, mcus_x: int,
                               level: int = 128, qtuple,
                               precision: str = "fast"):
    """FULL mesh-sharded decode of restart-interval 4:2:0 streams: the
    Huffman frontend itself runs on every shard (ops.entropy_decode
    lockstep scan) -- no host coefficients, no collectives.

    Segments are independent and MCU ranges are contiguous per shard, so
    the whole program (entropy decode -> dequant -> IDCT -> upsample ->
    color) is shard-local: 'data' shards images, 'tile' shards contiguous
    segment ranges (= MCU-row ranges when (nseg_loc * ri) % mcus_x == 0).

    fn(words [N, nseg, Lw] u32 P('data','tile',None),
       nblk [N, nseg] i32 P('data','tile'),
       lut [6, 65536] i32 replicated (build_decode_lut row layout))
      -> uint8 [N, H_mcu, W_mcu, 3] P('data','tile',None,None)
    with the reference's clamp-AFTER-color semantics (same pixels as the
    rgb transport).
    """
    from ..ops.entropy_decode import decode_segments

    dtype = jnp.float64 if precision == "exact" else jnp.float32
    mb = ri * 6

    def local(words, nblk, lut):
        n_loc, nseg_loc, Lw = words.shape
        # bad flags are unused here: the mesh path feeds trusted streams
        # (our own encoder's); the batch transport validates foreign input
        blocks, _bad = decode_segments(
            words.reshape(-1, Lw), nblk.reshape(-1), lut, max_blocks=mb)
        mcus_loc = nseg_loc * ri
        rows_loc = mcus_loc // mcus_x
        b6 = blocks.reshape(n_loc, mcus_loc, 6, 64)
        comps = (
            (b6[:, :, :4].reshape(n_loc, mcus_loc * 4, 64), 2, 2, 1, 1),
            (b6[:, :, 4], 1, 1, 2, 2),
            (b6[:, :, 5], 1, 1, 2, 2),
        )
        planes = []
        for (cb, v, h, dup_y, dup_x), qt in zip(comps, qtuple):
            deq = Q.dequantize(cb.reshape(-1, 64).astype(jnp.int32),
                               jnp.asarray(np.array(qt, np.int32)))
            spat = D.inverse_dct(deq, level, dtype)
            plane = spat.reshape(
                n_loc, rows_loc, mcus_x, v, h, 8, 8).transpose(
                0, 1, 3, 5, 2, 4, 6).reshape(
                n_loc, rows_loc * v * 8, mcus_x * h * 8)
            if dup_y > 1 or dup_x > 1:
                plane = jnp.repeat(
                    jnp.repeat(plane, dup_y, axis=1), dup_x, axis=2)
            planes.append(plane)
        r, g, b = C.ycc_to_rgb(planes[0], planes[1], planes[2], dtype)
        return jnp.stack([r, g, b], axis=-1)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("data", "tile", None), P("data", "tile"), P(None, None)),
        out_specs=P("data", "tile", None, None),
        # the scan's loop carries start as unvarying zeros
        # (ops.entropy_decode) and become shard-varying inside the loop
        check_vma=False,
    )
    return jax.jit(fn)


def shard_batch(mesh: Mesh, arr: np.ndarray) -> jax.Array:
    """Place [N, H, W] host batch onto the mesh with P('data', 'tile')."""
    return jax.device_put(arr, NamedSharding(mesh, P("data", "tile", None)))
