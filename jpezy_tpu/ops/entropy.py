"""Huffman entropy ENCODE as a batched array program (device, jnp).

The reference walks each block serially, emitting variable-length codes
through a bit cursor (src/encoder/jpezy_encoder.hpp:174-225).  Array-program
reformulation (cf. SURVEY.md section 2.7 and the GPU-JPEG literature):

 1. Every block's emission stream is expressed as exactly 64 *merged
    emissions*: slot 0 = DC (code + extra bits), slot j = zigzag position j
    (up to 3 ZRLs + code + extra, <= 59 bits, or EOB at slot 63).  All
    emissions are computed data-parallel across blocks and slots:
    zero-runs come from a max-scan over marked positions, magnitude
    categories from exact comparison ladders (no transcendentals).
 2. Bit offsets are exclusive cumsums of emission lengths.
 3. Per-block bit packing is scatter-free: each emission's <=59 bits are
    aligned into a 96-bit window of three 32-bit words, and windows are
    OR-accumulated into the block's word buffer under a word-index iota
    mask (disjoint bit patterns make OR == add) -- one fused
    broadcast-compare-reduce in plain XLA (pack_method).
 4. Cross-block concatenation ALSO happens on device (concat_device):
    block words are funnel-shifted by their global bit phase and
    scatter-added at sorted word offsets, so only ~stream-size bytes cross
    the host link.  Host-side splicing (bitstream/splice.py, C++) remains
    for sharded shard-stream assembly and as the overflow fallback.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import tables as T

WORDS_PER_BLOCK = 64  # 2048 bits >= worst-case block (<= ~1700 bits)


def _shr32(x, s):
    """x >> s for s in [0, 32+], returning 0 when s >= 32 (uint32)."""
    sm = jnp.clip(s, 0, 31)
    return jnp.where(s >= 32, jnp.uint32(0), x >> sm.astype(jnp.uint32))


def _shl32(x, s):
    sm = jnp.clip(s, 0, 31)
    return jnp.where(s >= 32, jnp.uint32(0), x << sm.astype(jnp.uint32))


def bit_category(v: jnp.ndarray, max_bits: int = 12) -> jnp.ndarray:
    """Magnitude category: bit length of |v| (exact comparison ladder).

    Matches the reference's shift-count loops (jpezy_encoder.hpp:183-185,
    202-204).  |v| < 2^max_bits required.
    """
    a = jnp.abs(v)
    s = jnp.zeros_like(v)
    for k in range(max_bits):
        s = s + (a >= (1 << k)).astype(v.dtype)
    return s


def _append(hi, lo, n, bits, nbits):
    """Append (bits, nbits<=16) to a 64-bit MSB-first accumulator (hi, lo, n)."""
    bits = bits.astype(jnp.uint32)
    nb = nbits.astype(jnp.int32)
    carry = _shr32(lo, 32 - nb)          # top nb bits of lo move into hi
    hi = jnp.where(nb > 0, _shl32(hi, nb) | carry, hi)
    lo = jnp.where(nb > 0, _shl32(lo, nb) | bits, lo)
    return hi, lo, n + nb


def dc_predictors(dc: jnp.ndarray) -> jnp.ndarray:
    """Previous DC in sequence; 0 for the first block
    (the reference's pre_DC chain, jpezy_encoder.hpp:180-181)."""
    return jnp.concatenate([jnp.zeros((1,), dc.dtype), dc[:-1]])


def dc_predictors_restart(dc: jnp.ndarray, seg_blocks: int) -> jnp.ndarray:
    """dc_predictors with a reset to 0 at every restart-segment start
    (T.81 F.2.1.3.1; decode analog jpezy_decoder.hpp:152-163).

    seg_blocks: blocks per restart segment FOR THIS COMPONENT
    (= restart_interval * blocks_per_mcu); <= 0 means one unbroken chain.
    """
    pred = dc_predictors(dc)
    if seg_blocks <= 0:
        return pred
    idx = jnp.arange(dc.shape[0], dtype=jnp.int32)
    return jnp.where(idx % seg_blocks == 0, jnp.zeros_like(pred), pred)


def _ac_run_size(qblocks: jnp.ndarray):
    """Shared AC run-length derivation over zigzag positions 1..63.

    Returns (zz [B,63] zigzag AC values, nz nonzero mask, zrl_count ZRL
    emissions before each nonzero, rem run&15, s_ac magnitude category).
    """
    B = qblocks.shape[0]
    zz = qblocks[:, jnp.asarray(T.ZIGZAG)][:, 1:]  # [B, 63]
    nz = zz != 0
    pos = jnp.arange(1, 64, dtype=jnp.int32)[None, :]
    marked = jnp.where(nz, pos, 0)
    prev_incl = jax_cummax(marked)
    prev_excl = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), prev_incl[:, :-1]], axis=1
    )
    run = pos - prev_excl - 1
    zrl_count = jnp.where(nz, run >> 4, 0)
    rem = run & 15
    s_ac = bit_category(zz)
    return zz, nz, zrl_count, rem, s_ac


def symbol_histograms(qblocks: jnp.ndarray, dc_pred: jnp.ndarray):
    """Huffman symbol frequencies for one component's blocks (pass 1 of the
    two-pass `optimize` encode -- the libjpeg -optimize analog).

    Returns (dc_hist [256], ac_hist [256]) int32: DC magnitude-category
    counts and AC RRRRSSSS symbol counts (incl. ZRL 0xF0 and EOB 0x00),
    exactly the symbols block_emissions would emit.
    """
    diff = qblocks[:, 0] - dc_pred
    s = bit_category(diff)
    dc_hist = jnp.zeros((256,), jnp.int32).at[s].add(1)

    zz, nz, zrl_count, rem, s_ac = _ac_run_size(qblocks)
    sym = (rem << 4) | s_ac
    ac_hist = jnp.zeros((256,), jnp.int32)
    ac_hist = ac_hist.at[jnp.where(nz, sym, 0)].add(nz.astype(jnp.int32))
    ac_hist = ac_hist.at[0xF0].add(zrl_count.sum().astype(jnp.int32))
    ac_hist = ac_hist.at[0x00].add(
        (~nz[:, -1]).sum().astype(jnp.int32))  # EOB per block
    return dc_hist, ac_hist


def _lookup_chain(table, idx, dtype=jnp.uint32):
    """Gather-free small-table lookup: compare-select chain over entries.

    The chain fuses into one elementwise pass instead of a per-element
    gather.  Chosen on the first target accelerator, where the gather form
    was far slower; not measured on the H100.
    table: [T] int array (constant or traced); idx: any-shape int array.
    """
    acc = jnp.zeros(idx.shape, dtype)
    for t in range(table.shape[0]):
        acc = jnp.where(idx == t, table[t].astype(dtype), acc)
    return acc


def _lookup_code_size(code_tb, size_tb, idx):
    """(code[idx] uint32, size[idx] int32) via ONE packed select chain.

    Codes are <= 16 bits and sizes <= 31, so (code << 8) | size packs into
    one int; a single chain halves the lookup cost vs two."""
    packed = (code_tb.astype(jnp.uint32) << 8) | size_tb.astype(jnp.uint32)
    pv = _lookup_chain(packed, idx)
    return pv >> 8, (pv & jnp.uint32(0xFF)).astype(jnp.int32)


def block_emissions(qblocks: jnp.ndarray, dc_pred: jnp.ndarray, chroma: bool,
                    tables=None):
    """[B, 64] quantized blocks -> merged emissions (hi, lo, nbits) [B, 64].

    Emission slot 0: DC code + extra bits.
    Slot j (1..63): ZRLs + AC code + extra for zigzag position j when the
    coefficient is nonzero; EOB at slot 63 when position 63 is zero.

    tables: optional (dc_size [12+], dc_code, ac_size [162], ac_code)
    arrays (traced ok) in the flat layouts of core.tables; None = the fixed
    Annex K tables selected by `chroma`.
    """
    B = qblocks.shape[0]
    if tables is None:
        dc_size = jnp.asarray(T.C_DC_SIZE if chroma else T.Y_DC_SIZE)
        dc_code = jnp.asarray(T.C_DC_CODE if chroma else T.Y_DC_CODE)
        ac_size = jnp.asarray(T.C_AC_SIZE if chroma else T.Y_AC_SIZE)
        ac_code = jnp.asarray(T.C_AC_CODE if chroma else T.Y_AC_CODE)
    else:
        dc_size, dc_code, ac_size, ac_code = tables
    zrl_s = ac_size[T.ZRL_INDEX]
    zrl_c = ac_code[T.ZRL_INDEX]
    eob_s = ac_size[T.EOB_INDEX]
    eob_c = ac_code[T.EOB_INDEX]

    # ---- DC (jpezy_encoder.hpp:179-192)
    dc = qblocks[:, 0]
    diff = dc - dc_pred
    s = bit_category(diff)
    hi0 = jnp.zeros((B,), jnp.uint32)
    lo0 = jnp.zeros((B,), jnp.uint32)
    n0 = jnp.zeros((B,), jnp.int32)
    dcc, dcs = _lookup_code_size(dc_code, dc_size, s)
    hi0, lo0, n0 = _append(hi0, lo0, n0, dcc, dcs)
    extra = (jnp.where(diff < 0, diff - 1, diff).astype(jnp.uint32)
             & (_shl32(jnp.uint32(1), s) - 1))
    hi0, lo0, n0 = _append(hi0, lo0, n0, extra, s)

    # ---- AC (jpezy_encoder.hpp:194-224)
    zz, nz, zrl_count, rem, s_ac = _ac_run_size(qblocks)
    idx = rem * 10 + s_ac + (rem == 15)

    hi = jnp.zeros((B, 63), jnp.uint32)
    lo = jnp.zeros((B, 63), jnp.uint32)
    n = jnp.zeros((B, 63), jnp.int32)
    for k in range(3):  # `while run > 15` ZRL loop, unrolled (max 3)
        on = nz & (zrl_count > k)
        hi, lo, n = _append(hi, lo, n, jnp.where(on, zrl_c, 0),
                            jnp.where(on, zrl_s, 0))
    acc_, acs_ = _lookup_code_size(ac_code, ac_size, idx)
    hi, lo, n = _append(hi, lo, n,
                        jnp.where(nz, acc_, 0),
                        jnp.where(nz, acs_, 0))
    extra_ac = (jnp.where(zz < 0, zz - 1, zz).astype(jnp.uint32)
                & (_shl32(jnp.uint32(1), s_ac) - 1))
    hi, lo, n = _append(hi, lo, n, jnp.where(nz, extra_ac, 0),
                        jnp.where(nz, s_ac, 0))

    # EOB at slot 63 when zigzag position 63 is zero (jpezy_encoder.hpp:219)
    eob = ~nz[:, -1]
    hi = hi.at[:, -1].set(jnp.where(eob, jnp.uint32(0), hi[:, -1]))
    lo = lo.at[:, -1].set(jnp.where(eob, jnp.uint32(eob_c), lo[:, -1]))
    n = n.at[:, -1].set(jnp.where(eob, eob_s, n[:, -1]))

    hi_all = jnp.concatenate([hi0[:, None], hi], axis=1)
    lo_all = jnp.concatenate([lo0[:, None], lo], axis=1)
    n_all = jnp.concatenate([n0[:, None], n], axis=1)
    return hi_all, lo_all, n_all


def jax_cummax(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive running max along axis 1."""
    import jax

    return jax.lax.cummax(x, axis=1)


def concat_device(words, bits, maxw: int):
    """Concatenate per-block bitstrings into one stream ON DEVICE.

    words: [B, W] uint32 per-block packed words; bits: [B] bit counts.
    Returns (stream [maxw] uint32 MSB-first, total_bits scalar).

    Each block's words are funnel-shifted by its global bit phase and
    scatter-added at its word offset (adjacent blocks touch disjoint bits of
    boundary words, so add == or).  Writes beyond maxw are dropped -- the
    caller must check total_bits <= 32*maxw and fall back to host splicing
    on overflow.

    Why on device: only ~stream-size bytes cross the host link instead of
    the 64x larger padded word buffers.
    """
    goff = jnp.cumsum(bits) - bits
    total = goff[-1] + bits[-1]
    return _scatter_stream(words, goff, bits, maxw), total


def concat_device_restart(words, bits, maxw: int, seg_blocks: int,
                          tiered: bool = True):
    """Segmented concat_device for restart-interval encode (extension).

    Every `seg_blocks` consecutive blocks form one restart segment; each
    segment is placed starting at a byte boundary (T.81 requires RSTn
    markers byte-aligned, with the previous segment 1-padded to a byte).

    Returns (stream [maxw] uint32, total_padded_bits, seg_bits [S] int32).
    The stream holds segment s at byte offset sum(ceil(seg_bits[:s]/8));
    the HOST still must OR 1-padding into each segment's final partial
    byte, byte-stuff each segment, and join with RSTn markers
    (jax_codec.encode does this) -- markers themselves must not be stuffed.
    """
    B, W = words.shape
    S = -(-B // seg_blocks)
    bp = jnp.pad(bits, (0, S * seg_blocks - B))
    bseg = bp.reshape(S, seg_blocks)
    seg_bits = bseg.sum(axis=1)
    seg_span = ((seg_bits + 7) // 8) * 8            # byte-aligned span
    base = jnp.cumsum(seg_span) - seg_span
    within = jnp.cumsum(bseg, axis=1) - bseg
    goff = (base[:, None] + within).reshape(-1)[:B]
    total = base[-1] + seg_span[-1]
    return _scatter_stream(words, goff, bits, maxw, tiered), total, seg_bits


# Scatter-add cost grows with the elements scattered, and the full
# 65-column contribution windows are mostly zeros: blocks are short --
# typical content runs ~13 bits/block (max ~45), even noise maxes out near
# 200 -- so the window is trimmed to the narrowest column tier that
# provably covers max(bits) + the 31-bit phase, picked at RUNTIME by
# lax.cond (the untaken branches never execute).  The bench corpus maxes
# at 45 bits/block -> tier 3; smooth content reaches tier 2.  Chosen on the
# first target accelerator, where the full-width scatter dominated the
# encode; not measured on the H100.
_SCATTER_TIERS = (2, 3, 4, 12)  # columns; tier C valid when bits <= 32*C-31


def _scatter_tiered(scat, contrib, bits, ncols: int):
    """stream = scat(contrib[..., :cols], cols) at the narrowest valid tier."""
    mb = jnp.max(bits)
    fn = lambda c: scat(c, ncols)  # noqa: E731  (full-width fallback)
    for cols in reversed(_SCATTER_TIERS):
        if cols >= ncols:
            continue
        fn = (lambda cols_, nxt: lambda c: jax.lax.cond(
            mb <= 32 * cols_ - 31, lambda cc: scat(cc, cols_), nxt, c
        ))(cols, fn)
    return fn(contrib)


def _scatter_stream(words, goff, bits, maxw: int, tiered: bool = True):
    """Funnel-shift each block's words to its global bit offset and
    scatter-add into a [maxw] uint32 stream (see concat_device).

    tiered=False skips the lax.cond window trim: under vmap a cond lowers
    to select and EXECUTES every branch, so any vmapped caller must keep
    the single full-width scatter.  (Since round 4 no product path vmaps
    this: the batched concats use the flattened global-scatter forms
    below; scripts/devstages.py keeps the vmapped variant to document the
    14.7x cost it had.)"""
    B, W = words.shape
    rr = (goff & 31).astype(jnp.uint32)
    q = goff >> 5
    ext = jnp.concatenate([jnp.zeros((B, 1), jnp.uint32), words], axis=1)
    sh = jnp.where(rr > 0, rr, 1)[:, None]
    shifted = jnp.where(
        rr[:, None] > 0, (ext[:, 1:] >> sh) | (ext[:, :-1] << (32 - sh)),
        ext[:, 1:],
    )
    carry = jnp.where(
        rr > 0, words[:, -1] << (32 - jnp.where(rr > 0, rr, 1)), 0
    ).astype(jnp.uint32)[:, None]
    # explicit uint32: under x64 the shift expressions promote to uint64,
    # which a uint32 scatter-add rejects in future jax versions
    contrib = jnp.concatenate([shifted, carry], axis=1).astype(jnp.uint32)

    def scat(c, cols):
        cc = c[:, :cols]
        idx = q[:, None] + jnp.arange(cols, dtype=q.dtype)[None, :]
        return jnp.zeros((maxw,), jnp.uint32).at[idx.reshape(-1)].add(
            cc.reshape(-1), mode="drop"
        )

    if not tiered:
        return scat(contrib, W + 1)
    return _scatter_tiered(scat, contrib, bits, W + 1)


def _concat_batch_scatter(words, bits, goff, maxw: int):
    """Shared tail of the batched concats: funnel-shift each block's words
    to its per-image global bit offset and scatter-add into a flattened
    [N*maxw] buffer with the runtime-tiered window trim (no vmap -- under
    vmap the lax.cond tiers would lower to select and execute every
    branch)."""
    N, B, W = words.shape
    rr = (goff & 31).astype(jnp.uint32)
    q = goff >> 5
    ext = jnp.concatenate([jnp.zeros((N, B, 1), jnp.uint32), words], axis=2)
    sh = jnp.where(rr > 0, rr, 1)[..., None]
    shifted = jnp.where(
        rr[..., None] > 0, (ext[..., 1:] >> sh) | (ext[..., :-1] << (32 - sh)),
        ext[..., 1:],
    )
    carry = jnp.where(
        rr > 0, words[..., -1] << (32 - jnp.where(rr > 0, rr, 1)), 0
    ).astype(jnp.uint32)[..., None]
    contrib = jnp.concatenate([shifted, carry], axis=2).astype(jnp.uint32)
    img = jnp.arange(N, dtype=q.dtype)[:, None, None] * maxw

    def scat(c, cols):
        cc = c[..., :cols]
        woff = q[..., None] + jnp.arange(cols, dtype=q.dtype)[None, None, :]
        # spills past an image's budget go out of range -> mode="drop"
        idx = jnp.where(woff < maxw, img + woff, N * maxw)
        return jnp.zeros((N * maxw,), jnp.uint32).at[idx.reshape(-1)].add(
            cc.reshape(-1), mode="drop"
        )

    return _scatter_tiered(scat, contrib, bits, W + 1).reshape(N, maxw)


def stream_offsets_batch(bits):
    """Global bit offsets for stream-ordered blocks: [N, B] bits ->
    (goff [N, B], total [N])."""
    goff = jnp.cumsum(bits, axis=1) - bits
    total = goff[:, -1] + bits[:, -1]
    return goff, total


def stream_offsets_restart_batch(bits, seg_blocks: int):
    """Segment-aligned bit offsets (restart encode): [N, B] stream-ordered
    bits -> (goff [N, B], total [N], seg_bits [N, S]).  Each segment
    starts byte-aligned (T.81 requires RSTn markers byte-aligned)."""
    N, B = bits.shape
    S = -(-B // seg_blocks)
    bp = jnp.pad(bits, ((0, 0), (0, S * seg_blocks - B)))
    bseg = bp.reshape(N, S, seg_blocks)
    seg_bits = bseg.sum(axis=2)
    seg_span = ((seg_bits + 7) // 8) * 8            # byte-aligned span
    base = jnp.cumsum(seg_span, axis=1) - seg_span
    within = jnp.cumsum(bseg, axis=2) - bseg
    goff = (base[:, :, None] + within).reshape(N, -1)[:, :B]
    total = base[:, -1] + seg_span[:, -1]
    return goff, total, seg_bits


def concat_device_batch(words, bits, maxw: int):
    """Batched concat_device: [N, B, W] + [N, B] -> ([N, maxw], [N]).

    One global scatter over a flattened [N*maxw] buffer (no vmap)."""
    goff, total = stream_offsets_batch(bits)
    return _concat_batch_scatter(words, bits, goff, maxw), total


def concat_device_restart_batch(words, bits, maxw: int, seg_blocks: int):
    """Batched concat_device_restart: [N, B, W] + [N, B] ->
    ([N, maxw], total [N], seg_bits [N, S]).

    Same segment-aligned offsets as concat_device_restart, but ONE global
    flattened scatter with the tiered window trim instead of a vmap of
    per-image scatters -- the vmapped form had to disable the tiers (cond
    -> select under vmap) and measured 56.6 ms/batch vs 4.1 for the
    restart-free concat (scripts/devstages.py, round 4)."""
    goff, total, seg_bits = stream_offsets_restart_batch(bits, seg_blocks)
    return _concat_batch_scatter(words, bits, goff, maxw), total, seg_bits


def _shr64_low32(hi, lo, d):
    """low 32 bits of (hi:lo) >> d, d in [0, 63]; 0 for d >= 64."""
    low = _shr32(lo, d) | _shl32(hi, 32 - d)     # valid when d < 32
    high = _shr32(hi, d - 32)                    # valid when d >= 32
    return jnp.where(d < 32, low, high)


def _window_words(hi, lo, nbits, off):
    """Align each emission's <=59 bits into a 96-bit window of 3 words.

    Returns (w0 [.., E] start word index, (W0, W1, W2) window word values).
    """
    w0 = off >> 5
    p = off & 31
    # value v (nbits long) placed so its MSB sits at bit p of W0
    sh = 96 - p - nbits                              # in [6, 96]
    wwords = []
    for k in range(3):
        d = 32 * (2 - k) - sh                        # W_k = low32(v >> d), shl if d<0
        pos_part = _shr64_low32(hi, lo, jnp.clip(d, 0, 63))
        neg_part = _shl32(lo, jnp.clip(-d, 0, 32))
        wk = jnp.where(d >= 0, jnp.where(d < 64, pos_part, 0),
                       jnp.where(-d < 32, neg_part, 0))
        wk = jnp.where(nbits > 0, wk, jnp.uint32(0))
        wwords.append(wk)
    return w0, wwords


def pack_method() -> str:
    """Which pack implementation to use: 'reduce' (default), 'prefix' or
    'fori'; JPEZY_PACK overrides.  All three are plain XLA and bit-equal
    (tests/test_entropy_vectors.py); the reduce form fuses into one
    broadcast-compare-reduce over the emission axis.  Times of the three
    inside the fused encode on the H100 are in PERF.md."""
    import os

    m = os.environ.get("JPEZY_PACK")
    return m if m in ("prefix", "reduce", "fori") else "reduce"


def _pack_words_reduce(w0, wwords):
    """Masked-sum pack: packed[b, w] = sum_e sum_j Wj[b,e] * [w0[b,e]+j == w].

    Bit-disjointness across emissions makes integer ADD == OR, so the whole
    pack is one fused broadcast-compare-reduce over the emission axis (no
    sequential 64-step loop).
    """
    iota = jnp.arange(WORDS_PER_BLOCK, dtype=w0.dtype)[None, None, :]
    t = w0[:, :, None]                                   # [B, E, 1]
    z = jnp.uint32(0)
    contrib = (
        jnp.where(t == iota, wwords[0][:, :, None], z)
        | jnp.where(t + 1 == iota, wwords[1][:, :, None], z)
        | jnp.where(t + 2 == iota, wwords[2][:, :, None], z)
    )
    return contrib.sum(axis=1)                           # [B, W]


def _pack_words_prefix(w0, wwords):
    """Prefix-sum pack (cumsum + rank counts + gathers; see _pack_words_reduce
    for the add==or argument).

    w0 is NONDECREASING over the emission axis (it is a word offset derived
    from a cumsum), so for each window slot j the emissions targeting word w
    form a contiguous run [C[w-j-1], C[w-j]) where C[x] = #{e : w0[e] <= x}.
    Each run's sum comes from a prefix table: 3 cumsums + 3 gathers total.
    """
    B, E = w0.shape
    iota = jnp.arange(WORDS_PER_BLOCK, dtype=w0.dtype)[None, None, :]
    # C_le[b, w] = #{e : w0[b, e] <= w}  (fused compare-reduce)
    c_le = (w0[:, :, None] <= iota).astype(jnp.int32).sum(axis=1)  # [B, W]
    zero = jnp.zeros((B, 1), jnp.int32)
    c_pad = jnp.concatenate([zero, zero, zero, c_le], axis=1)  # C[w-3..]
    out = jnp.zeros((B, WORDS_PER_BLOCK), jnp.uint32)
    for j in range(3):
        # prefix sums of the j-th window word (exclusive, leading 0);
        # uint32 adds of bit-disjoint values never carry
        p = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.uint32),
             jnp.cumsum(wwords[j], axis=1, dtype=jnp.uint32)], axis=1)
        end = c_pad[:, 3 - j : 3 - j + WORDS_PER_BLOCK]
        start = c_pad[:, 2 - j : 2 - j + WORDS_PER_BLOCK]
        out = out | (jnp.take_along_axis(p, end, axis=1)
                     - jnp.take_along_axis(p, start, axis=1))
    return out


def pack_block_words(hi, lo, nbits):
    """Pack merged emissions into per-block 32-bit words.

    hi, lo: [B, 64] uint32 emission values (MSB-justified in (hi:lo) low bits),
    nbits: [B, 64] int32 emission lengths (<= 59).
    Returns (words [B, WORDS_PER_BLOCK] uint32 MSB-first, bits_per_block [B]).

    Scatter-free: each emission is aligned into a 96-bit window (3 words)
    starting at its word offset; a fori_loop over the 64 emission slots
    accumulates windows into the word buffer with masked adds (disjoint bit
    patterns, so add == or).  All shapes static; pure VPU work.
    """
    import jax

    B, E = nbits.shape
    off = jnp.cumsum(nbits, axis=1) - nbits          # exclusive
    total = off[:, -1] + nbits[:, -1]
    w0, wwords = _window_words(hi, lo, nbits, off)

    method = pack_method()
    if method == "prefix":
        return _pack_words_prefix(w0, wwords), total
    if method == "reduce":
        return _pack_words_reduce(w0, wwords), total

    wstack = jnp.stack(wwords)                       # [3, B, E]

    warange = jnp.arange(WORDS_PER_BLOCK, dtype=jnp.int32)[None, :]  # [1, W]

    def body(e, words):
        w0e = jax.lax.dynamic_slice_in_dim(w0, e, 1, axis=1)         # [B, 1]
        for k in range(3):
            vk = jax.lax.dynamic_slice_in_dim(wstack[k], e, 1, axis=1)  # [B, 1]
            words = words | jnp.where(warange == w0e + k, vk, jnp.uint32(0))
        return words

    # derive the zero init from an input so it inherits sharding/varying axes
    # (a bare jnp.zeros carry breaks under shard_map's manual-axes checks)
    init = jnp.broadcast_to(
        w0[:, :1].astype(jnp.uint32) & jnp.uint32(0), (B, WORDS_PER_BLOCK)
    )
    words = jax.lax.fori_loop(0, E, body, init)
    return words, total
