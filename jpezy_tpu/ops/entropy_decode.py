"""Device-side Huffman entropy DECODE over restart segments (pure XLA).

The reference's decode frontend is a strictly serial bit chain
(jpezy_decoder.hpp:583-642): one cursor, one symbol at a time.  DESIGN.md
section 4 keeps that on the host for arbitrary streams -- but restart
segments (T.81 F.2.1.3.1) are byte-aligned, reset the DC predictors, and
are therefore *independently decodable*: an image encoded with
restart_interval R yields ceil(nmcu/R) segments, and a batch yields
thousands of independent lanes.

This module decodes ALL segments in lockstep:

  outer `lax.scan` over block slots (R MCUs x 6 blocks per segment);
    inner `lax.while_loop` over Huffman symbols until every lane finished
    its current block;
      per symbol and per lane: one 32-bit refill gather from the destuffed
      big-endian word matrix into a per-lane 64-bit window register, one
      combined-LUT gather ([T, 6, 65536]: table-set x component-class
      rows, value = (HUFFVAL<<8)|bits, same entry layout as the host LUT
      in runtime/native.py), then branch-free vector ops: category
      extraction, T.81 F.2.2.1 sign extension, ZRL/EOB control, and a
      one-hot accumulate into the current [S, 64] block register (the
      zigzag->natural permutation is a compile-time column permute, so
      there is NO scatter anywhere).

Per-lane TABLE SELECT (round 5): each lane carries a table-set index
`tsel` into the leading LUT axis, so a batch may mix streams with
different DHT tables (foreign restart JPEGs, our own optimize=True output
whose tables are per-image) -- the reference decodes arbitrary DHT
assignments (jpezy_decoder.hpp:190-256) and so does this path now.
Identical table sets are deduplicated host-side and the device copy is
content-cached, so the standard Annex-K case uploads one 1.5 MiB LUT once
per process.

CORRUPTION SIGNAL (round 5): the reference propagates negative returns on
invalid codes (jpezy_decoder.hpp:593,635); the lockstep scan accumulates a
per-lane `bad` flag instead of silently skipping:
  - invalid LUT window (no code matches),
  - AC coefficient index overflow (run crosses position 63, the
    reference's -5),
  - ZRL pushing the index past 63,
  - and, with `rawlen` given, a final bit-consumption mismatch: a valid
    segment consumes exactly ceil(bits/8) == rawlen destuffed bytes, so
    any code-length drift a bit flip causes is caught even when every
    window stays decodable (stronger than the reference's check).

Completed blocks flush through the scan's ys into [S, max_blocks, 64]
int16 -- MCU slot order (Y0 Y1 Y2 Y3 Cb Cr), which reshapes directly into
the per-component layout the dequant/IDCT backend consumes.  The upload
for a full decode is raw destuffed entropy bytes (~0.07 B/px) instead of
sparse coefficients (~0.6 B/px).

Everything is int32 arithmetic on [S]-vectors: no data-dependent Python
control flow, static shapes, one compiled program per
(S, Lw, max_blocks, T) bucket.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core import tables as T

# natural-position one-hot from a zigzag-index one-hot: column permutation
# taking zigzag position k to natural position ZIGZAG[k] (static, free).
_ZZ_INV = np.asarray(T.NATURAL_TO_ZIGZAG)  # [natural j] -> zigzag k

_STD_TDTA = ((0, 0), (1, 1), (1, 1))


def build_decode_lut(huff, scan_components=None) -> np.ndarray:
    """[6, 65536] int32 combined decode LUT from parsed DHT tables.

    huff: ParsedJpeg.huff ({0: dc tables, 1: ac tables} keyed by table id).
    scan_components: the stream's Td/Ta assignment (ParsedJpeg
    .scan_components); None = the standard Y->0, C->1 assignment.
    Rows: comp c's DC at 2c, AC at 2c+1.
    Entry = (HUFFVAL << 8) | code_bits for the 16-bit window, -1 invalid
    (same contract as the host LUT, runtime/native.py:_huff_lut).
    """
    from ..runtime.native import _huff_lut

    tdta = (_STD_TDTA if scan_components is None
            else [(sc.Td, sc.Ta) for sc in scan_components])
    if len(tdta) != 3:
        raise ValueError("device decode LUT needs 3 scan components")
    rows = []
    for td, ta in tdta:
        rows.append(_huff_lut(huff[0][td]))
        rows.append(_huff_lut(huff[1][ta]))
    return np.stack(rows)


CHAIN_COLS = 3 * 17 + 162   # packed canonical-table row width (see below)


def build_decode_chain_tables(huff, scan_components=None) -> np.ndarray:
    """[6, CHAIN_COLS] int32 canonical decode tables for the gather-free
    'chain' scan mode (see decode_segments).

    Row r (comp c's DC at 2c, AC at 2c+1) packs, per code length
    l in 0..16: first[l] (cols 0..16), count[l] (17..33), offset[l]
    (34..50), then the HUFFVAL list in canonical order (51..212, padded
    with 0).  first/count/offset are the classic canonical-Huffman decode
    triple: a 16-bit window's code of length l is win >> (16-l); it
    matches length l iff first[l] <= code < first[l]+count[l], and its
    symbol is values[offset[l] + code - first[l]].
    """
    tdta = (_STD_TDTA if scan_components is None
            else [(sc.Td, sc.Ta) for sc in scan_components])
    if len(tdta) != 3:
        raise ValueError("device decode tables need 3 scan components")
    rows = []
    for td, ta in tdta:
        for cls, tid in ((0, td), (1, ta)):
            t = huff[cls][tid]
            row = np.zeros(CHAIN_COLS, np.int32)
            sizes = np.asarray(t.sizes, np.int32)
            codes = np.asarray(t.codes, np.int32)
            vals = np.asarray(t.values, np.int32)
            if len(vals) > 162:
                raise ValueError("more than 162 Huffman symbols")
            for L in range(1, 17):
                m = sizes == L
                row[17 + L] = int(m.sum())              # count
                if m.any():
                    row[L] = int(codes[m][0])           # first
                    row[34 + L] = int(np.nonzero(m)[0][0])  # offset
            row[51: 51 + len(vals)] = vals
            rows.append(row)
    return np.stack(rows)


def scan_mode() -> str:
    """'chain' (gather-free canonical compare-chain symbol decode) or
    'lut' (65536-entry window-LUT gather); JPEZY_SCAN overrides.  The
    default is 'lut' on every backend: the H100 runs it faster than the
    chain (chip_smoke.py's scan race, PERF.md), and on the CPU the chain's
    ~180 extra selects per symbol cost several times the gather."""
    import os

    m = os.environ.get("JPEZY_SCAN")
    return m if m in ("chain", "lut") else "lut"


def build_scan_tables(huff, scan_components=None) -> np.ndarray:
    """The scan_mode()-appropriate decode tables for decode_segments."""
    if scan_mode() == "chain":
        return build_decode_chain_tables(huff, scan_components)
    return build_decode_lut(huff, scan_components)


def lut_content_key(huff, scan_components=None) -> bytes:
    """Content hash of the table set a stream resolves to -- the dedup key
    for batching streams with mixed DHT tables."""
    import hashlib

    tdta = (_STD_TDTA if scan_components is None
            else [(sc.Td, sc.Ta) for sc in scan_components])
    hsh = hashlib.sha1()
    for td, ta in tdta:
        for cls, tid in ((0, td), (1, ta)):
            t = huff[cls][tid]
            hsh.update(np.asarray(t.sizes, np.int32).tobytes())
            hsh.update(np.asarray(t.codes, np.int32).tobytes())
            hsh.update(np.asarray(t.values, np.int32).tobytes())
    return hsh.digest()


@functools.lru_cache(maxsize=8)
def _device_lut(key, lut_bytes: bytes, shape) -> jax.Array:
    """Device-resident LUT, cached by content hash: standard streams all
    share the Annex K tables, so the upload happens once per process, not
    once per batch."""
    return jnp.asarray(np.frombuffer(lut_bytes, np.int32).reshape(shape))


def device_lut(lut: np.ndarray) -> jax.Array:
    b = np.ascontiguousarray(lut, np.int32).tobytes()
    import hashlib

    return _device_lut(hashlib.sha1(b).hexdigest(), b, lut.shape)


def sym_unroll() -> int:
    """Symbols decoded per while-loop iteration (JPEZY_SCAN_UNROLL).

    Each unrolled symbol is fully masked for lanes that finished their
    block, so semantics are unroll-invariant.  Default 1: unrolling did not
    pay on the first target accelerator; not measured on the H100, where
    each while-loop iteration may cost a predicate round trip to the host
    (ROADMAP 1.4)."""
    import os

    try:
        u = int(os.environ.get("JPEZY_SCAN_UNROLL", "1"))
    except ValueError:
        u = 1
    return max(1, min(u, 8))


@functools.partial(jax.jit, static_argnames=("max_blocks", "unroll"))
def decode_segments(words, nblk, lut, tsel=None, rawlen=None,
                    skip0=None, preds0=None, *, max_blocks: int,
                    unroll: int | None = None):
    """Lockstep-decode S restart segments -> dense coefficient blocks.

    words: [S, Lw] uint32, big-endian-packed DESTUFFED segment bytes,
      zero-padded (>= 4 pad bytes past the last entropy byte per row).
    nblk:  [S] int32, blocks to decode per segment (tail segments and
      batch padding lanes decode fewer; their remaining blocks are zeros).
    lut:   [T, 6, 65536] int32 ([6, 65536] accepted as T == 1;
      build_decode_lut / device_lut).
    tsel:  [S] int32 table-set index per lane into lut's leading axis
      (None = all lanes use set 0).
    rawlen: [S] int32 destuffed byte length per lane; when given, a final
      bit-consumption mismatch sets the lane's bad flag (see module doc).
    skip0: [S] int32 bits to pre-consume per lane (0..7) -- pseudo-segments
      of the index-assisted restart-free decode start at arbitrary bit
      offsets within their row's first byte (SURVEY 2.7 option (b)).
    preds0: [S, 3] int32 initial DC predictors per lane (the index scan's
      absolute DC values; None = zeros, the restart semantics).
    max_blocks: R * blocks_per_mcu, the scan length.

    Returns (blocks [S, max_blocks, 64] int16 natural-order with DC
    absolute within each segment, bad [S] bool corruption flags).
    """
    if lut.ndim == 2:
        lut = lut[None]
    chain = lut.shape[-1] == CHAIN_COLS
    S, Lw = words.shape
    iota64 = jnp.arange(64, dtype=jnp.int32)
    zero_s = jnp.zeros((S,), jnp.int32)
    zero_u = jnp.zeros((S,), jnp.uint32)
    base6 = (jnp.zeros((S,), jnp.int32) if tsel is None
             else tsel.astype(jnp.int32) * 6)
    if chain:
        # gather-free symbol decode: per-lane canonical tables resident as
        # [S, 6, CHAIN_COLS] (a bulk slice-take, not a per-element gather)
        if tsel is None or lut.shape[0] == 1:
            lane_tabs = jnp.broadcast_to(lut[0][None], (S,) + lut.shape[1:])
        else:
            lane_tabs = jnp.take(lut, tsel.astype(jnp.int32), axis=0)
    else:
        lutf = lut.reshape(-1)

    def sym_lut(win16, is_dc, row, _tab_c):
        """One combined-LUT gather: (HUFFVAL<<8)|len from the 16-bit
        window."""
        sel = row + (~is_dc).astype(jnp.int32)
        e = lutf[sel * 65536 + win16]
        badsym = e < 0
        ln = jnp.where(badsym, 8, e & 0xFF)
        val = jnp.where(badsym, 0, e >> 8)
        return ln, val, badsym

    def sym_chain(win16, is_dc, _row, tab_c):
        """Gather-free canonical decode: 16-step first/count compare chain
        for the code length, then a 162-way select chain for the HUFFVAL.
        ~500 elementwise ops/lane instead of one latency-bound gather
        (cf. ops.entropy._lookup_chain).  Which form wins is a property of
        the device: see scan_mode.
        tab_c: [S, 2, CHAIN_COLS] this component's DC/AC rows."""
        symlen = jnp.zeros_like(win16)
        rank = jnp.zeros_like(win16)
        for L in range(1, 17):
            fl = jnp.where(is_dc, tab_c[:, 0, L], tab_c[:, 1, L])
            cl = jnp.where(is_dc, tab_c[:, 0, 17 + L], tab_c[:, 1, 17 + L])
            ol = jnp.where(is_dc, tab_c[:, 0, 34 + L], tab_c[:, 1, 34 + L])
            code = win16 >> (16 - L)
            ok = (symlen == 0) & (code >= fl) & (code - fl < cl)
            symlen = jnp.where(ok, L, symlen)
            rank = jnp.where(ok, ol + code - fl, rank)
        vals = jnp.where(is_dc[:, None], tab_c[:, 0, 51:], tab_c[:, 1, 51:])
        hv = jnp.zeros_like(rank)
        for t in range(162):
            hv = jnp.where(rank == t, vals[:, t], hv)
        badsym = symlen == 0
        ln = jnp.where(badsym, 8, symlen)
        val = jnp.where(badsym, 0, hv)
        return ln, val, badsym

    sym_fn = sym_chain if chain else sym_lut

    # Bit cursor = a per-lane 64-bit window register (hi, lo uint32 pair):
    # `navail` valid bits at the TOP, zeros below, next stream bit = MSB of
    # hi.  One symbol consumes <= 27 bits (16-bit code + 11 extra), so ONE
    # 32-bit refill per iteration keeps navail >= 32 -- a single word
    # gather per symbol instead of the two adjacent-word gathers of the
    # bitpos formulation.

    def refill(hi, lo, navail, widx, active):
        need = active & (navail < 32)
        w = jnp.take_along_axis(
            words, jnp.minimum(widx, Lw - 1)[:, None], axis=1)[:, 0]
        na = navail.astype(jnp.uint32)
        hi2 = hi | (w >> na)
        lo2 = lo | jnp.where(navail > 0, w << ((32 - na) & 31), 0)
        return (jnp.where(need, hi2, hi), jnp.where(need, lo2, lo),
                jnp.where(need, navail + 32, navail),
                jnp.where(need, widx + 1, widx))

    def consume(hi, lo, navail, k, active):
        ku = jnp.maximum(k, 1).astype(jnp.uint32)   # k==0 -> masked out
        hi2 = (hi << ku) | (lo >> ((32 - ku) & 31))
        lo2 = lo << ku
        take = active & (k > 0)
        return (jnp.where(take, hi2, hi), jnp.where(take, lo2, lo),
                jnp.where(take, navail - k, navail))

    nun = sym_unroll() if unroll is None else unroll

    def _sym_step(carry, row, tab_c):
        # row/tab_c are loop-INVARIANT: closed over per outer step, never
        # carried (a carried [S, 2, 213] table would be copied every
        # while-loop iteration)
        hi, lo, navail, widx, kk, blk, pred, done, bad = carry
        active = ~done
        hi, lo, navail, widx = refill(hi, lo, navail, widx, active)
        win = hi
        is_dc = kk == 0
        # invalid windows only occur on corrupt streams; treat as an 8-bit
        # skip so the loop still terminates, and FLAG the lane (the
        # reference propagates a negative return, jpezy_decoder.hpp:593)
        ln, val, badsym = sym_fn((win >> 16).astype(jnp.int32), is_dc,
                                 row, tab_c)
        run = val >> 4
        s_ = val & 15
        ncat = jnp.where(is_dc, val, s_)          # extra (category) bits
        # extra bits follow the code inside the same 32-bit window
        # (ln <= 16, ncat <= 15 -> ln + ncat <= 31)
        extra = ((win << ln.astype(jnp.uint32))
                 >> ((32 - ncat) & 31).astype(jnp.uint32)).astype(jnp.int32)
        extra = jnp.where(ncat == 0, 0, extra)
        # T.81 F.2.2.1 sign extension (jpezy_decoder.hpp:590-592 semantics)
        top = (extra >> jnp.maximum(ncat - 1, 0)) & 1
        v = jnp.where((ncat > 0) & (top == 0),
                      extra - ((1 << ncat) - 1), extra)
        is_eob = (~is_dc) & (s_ == 0) & (run != 15)
        is_zrl = (~is_dc) & (s_ == 0) & (run == 15)
        dc_new = pred + v
        kk_ac = kk + run                           # this AC's zigzag index
        ac_over = (~is_dc) & (s_ > 0) & (kk_ac > 63)   # reference's -5
        zrl_over = is_zrl & (kk + 16 > 63)   # 16 zeros past the block end
        bad = bad | (active & (badsym | ac_over | zrl_over))
        write = active & ~is_eob & ~is_zrl & jnp.where(is_dc, True, kk_ac <= 63)
        wval = jnp.where(is_dc, dc_new, v)
        wpos_zz = jnp.where(is_dc, 0, kk_ac)       # zigzag index written
        onehot_zz = (iota64[None, :] == wpos_zz[:, None]) & write[:, None]
        # zigzag->natural: static column permutation, no gather
        onehot_nat = onehot_zz[:, _ZZ_INV]
        blk = blk + jnp.where(onehot_nat, wval[:, None], 0)
        pred = jnp.where(active & is_dc, dc_new, pred)
        kk = jnp.where(
            active,
            jnp.where(is_dc, 1,
                      jnp.where(is_zrl, kk + 16, kk_ac + 1)),
            kk)
        hi, lo, navail = consume(hi, lo, navail, ln + ncat, active)
        # kk > 63 ends the block; the word-index bound makes corrupt input
        # (invalid windows never advancing kk) terminate instead of hanging
        done = done | (active & (is_eob | (kk > 63))) | (widx > Lw)
        return hi, lo, navail, widx, kk, blk, pred, done, bad

    def outer(carry, b):
        hi, lo, navail, widx, preds, bad = carry   # preds [S, 3]
        slot = b % 6                               # Y0..Y3, Cb, Cr
        comp = jnp.where(slot < 4, 0, slot - 3)
        pred0 = jnp.take_along_axis(
            preds, jnp.full((S, 1), comp, jnp.int32), axis=1)[:, 0]
        row = base6 + comp * 2                     # lane's DC row in lutf
        if chain:                                  # [S, 2, C]: comp's rows
            tab_c = jax.lax.dynamic_slice_in_dim(
                lane_tabs, comp * 2, 2, axis=1)
        else:
            tab_c = None

        def block_body(c):
            for _ in range(nun):   # unrolled symbols, each fully masked
                c = _sym_step(c, row, tab_c)
            return c

        done0 = b >= nblk
        init = (hi, lo, navail, widx, zero_s,
                jnp.zeros((S, 64), jnp.int32), pred0, done0, bad)
        hi, lo, navail, widx, _, blk, pred, _, bad = \
            jax.lax.while_loop(
                lambda c: jnp.any(~c[7]), block_body, init)
        col = jnp.arange(3, dtype=jnp.int32)[None, :]
        preds = jnp.where(col == comp, pred[:, None], preds)
        return (hi, lo, navail, widx, preds, bad), blk.astype(jnp.int16)

    hi0, lo0, na0, wi0 = zero_u, zero_u, zero_s, zero_s
    if skip0 is not None:
        # pre-consume the intra-byte phase of each lane's start offset
        all_on = jnp.ones((S,), bool)
        hi0, lo0, na0, wi0 = refill(hi0, lo0, na0, wi0, all_on)
        hi0, lo0, na0 = consume(hi0, lo0, na0, skip0.astype(jnp.int32),
                                all_on)
    p0 = (jnp.zeros((S, 3), jnp.int32) if preds0 is None
          else preds0.astype(jnp.int32))
    init = (hi0, lo0, na0, wi0, p0, jnp.zeros((S,), bool))
    (hi, lo, navail, widx, _, bad), blocks = jax.lax.scan(
        outer, init, jnp.arange(max_blocks, dtype=jnp.int32))
    if rawlen is not None:
        # a valid segment's payload bits land in the last destuffed byte:
        # consumed in (8*(rawlen-1), 8*rawlen].  Catches code-length drift
        # from bit flips even when every window decodes (module doc).
        consumed = widx * 32 - navail
        exp = rawlen.astype(jnp.int32) * 8
        bad = bad | (consumed > exp) | (consumed <= exp - 8)
    return blocks.transpose(1, 0, 2), bad           # [S, max_blocks, 64]
