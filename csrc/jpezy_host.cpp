// jpezy_tpu native host runtime.
//
// Split: all per-block math runs on the accelerator (JAX/XLA); this
// library covers the byte-granular host work the reference did in C++
// (SURVEY.md sections 2.2, 2.5): ASCII PPM tokenizing, entropy bitstream
// splice/stuffing, and the serial Huffman DECODE frontend (bit cursor +
// canonical-code LUT walk), which produces [nblocks, 64] coefficient arrays
// for the device backend.
//
// Behavioral contracts mirrored from the reference:
//   - bit-by-bit canonical Huffman decode with table-driven fast path
//     (jpezy_decoder.hpp:583-642 semantics via 16-bit window LUTs)
//   - DC sign extension `v -= (1<<cat)-1` (jpezy_decoder.hpp:590-592)
//   - de-zigzag scatter into natural order (jpezy_decoder.hpp:622)
//   - byte stuffing 0xFF -> 0xFF 0x00 on encode, inverse + RSTn handling on
//     decode (srook bofstream/bifstream contract, SURVEY.md section 2.5)
//
// Build: g++ -O3 -march=native -shared -fPIC (see runtime/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// De-stuff entropy data: drop the 0x00 after each 0xFF; stop at any marker.
// Returns destuffed length; *consumed gets input bytes consumed.
// ---------------------------------------------------------------------------
long jz_destuff(const uint8_t* in, long n, uint8_t* out, long* consumed) {
    long o = 0, i = 0;
    while (i < n) {
        uint8_t b = in[i];
        if (b == 0xFF) {
            if (i + 1 < n && in[i + 1] == 0x00) {
                out[o++] = 0xFF;
                i += 2;
                continue;
            }
            break;  // marker
        }
        out[o++] = b;
        ++i;
    }
    if (consumed) *consumed = i;
    return o;
}

// forward declaration (defined below)
int64_t jz_entropy_decode(
    const uint8_t* data, long nbytes,
    const int32_t* const* dc_luts, const int32_t* const* ac_luts,
    const int32_t* zigzag, int ncomp,
    const int32_t* comp_h, const int32_t* comp_v,
    int64_t n_mcus, int restart_interval,
    int16_t* const* out_coeffs);

// ---------------------------------------------------------------------------
// Find restart-marker byte offsets (positions AFTER each FF D0-D7 pair).
// In stuffed entropy data 0xFF is always followed by 0x00 except at markers,
// so a flat scan is unambiguous.  Returns count written (up to cap).
// ---------------------------------------------------------------------------
long jz_find_restarts(const uint8_t* d, long n, int64_t* out, long cap) {
    long cnt = 0;
    for (long i = 0; i + 1 < n && cnt < cap; ++i) {
        if (d[i] == 0xFF) {
            uint8_t b = d[i + 1];
            if (b >= 0xD0 && b <= 0xD7) {
                out[cnt++] = i + 2;
                ++i;
            } else if (b != 0x00) {
                break;  // real marker terminates entropy data
            }
        }
    }
    return cnt;
}

// ---------------------------------------------------------------------------
// Destuff each restart segment into fixed-stride rows (prep for the DEVICE
// entropy decoder, jpezy_tpu/ops/entropy_decode.py: segments decode in
// lockstep from a [nseg, L] byte matrix).  seg_offsets[s] = byte offset of
// segment s's entropy data; each segment ends at its next marker.  out is
// caller-zeroed [nseg * L]; rows stay zero-padded.  Multithreaded over
// segments.  Returns the max destuffed length, or -(s+1) if segment s
// overflowed L.
// ---------------------------------------------------------------------------
long jz_destuff_segments(const uint8_t* d, long n,
                         const int64_t* seg_offsets, long nseg,
                         uint8_t* out, long L, int64_t* out_lens,
                         int nthreads) {
    if (nthreads <= 0) {
        nthreads = (int)std::thread::hardware_concurrency();
        if (nthreads <= 0) nthreads = 4;
    }
    std::vector<long> maxlen((size_t)nthreads, 0);
    std::vector<long> err((size_t)nthreads, 0);
    auto work = [&](int t, long s0, long s1) {
        for (long s = s0; s < s1; ++s) {
            long i = seg_offsets[s];
            uint8_t* row = out + s * L;
            long o = 0;
            while (i < n) {
                uint8_t b = d[i];
                if (b == 0xFF) {
                    if (i + 1 < n && d[i + 1] == 0x00) {
                        if (o >= L) { err[t] = s + 1; break; }
                        row[o++] = 0xFF;
                        i += 2;
                        continue;
                    }
                    break;  // marker ends the segment
                }
                if (o >= L) { err[t] = s + 1; break; }
                row[o++] = b;
                ++i;
            }
            if (out_lens) out_lens[s] = o;  // for the device decoder's
                                            // bit-consumption check
            if (o > maxlen[t]) maxlen[t] = o;
        }
    };
    if (nthreads == 1 || nseg < 16) {
        work(0, 0, nseg);
    } else {
        long per = (nseg + nthreads - 1) / nthreads;
        std::vector<std::thread> threads;
        for (int t = 0; t < nthreads; ++t) {
            long s0 = (long)t * per, s1 = s0 + per < nseg ? s0 + per : nseg;
            if (s0 >= s1) break;
            threads.emplace_back(work, t, s0, s1);
        }
        for (auto& th : threads) th.join();
    }
    long mx = 0;
    for (int t = 0; t < nthreads; ++t) {
        if (err[t]) return -err[t];
        if (maxlen[t] > mx) mx = maxlen[t];
    }
    return mx;
}

// ---------------------------------------------------------------------------
// ASCII integer scanning (PPM P3 parse).  Returns count of ints written.
// ---------------------------------------------------------------------------
long jz_scan_ints_i32(const char* s, long n, int32_t* out, long cap) {
    long count = 0;
    long i = 0;
    while (i < n && count < cap) {
        // skip whitespace and comment lines
        while (i < n) {
            char c = s[i];
            if (c == '#') {
                while (i < n && s[i] != '\n') ++i;
            } else if (c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
                       c == '\v' || c == '\f') {
                ++i;
            } else {
                break;
            }
        }
        if (i >= n) break;
        bool neg = false;
        if (s[i] == '-') { neg = true; ++i; }
        int32_t v = 0;
        bool any = false;
        while (i < n && s[i] >= '0' && s[i] <= '9') {
            v = v * 10 + (s[i] - '0');
            ++i; any = true;
        }
        if (!any) { ++i; continue; }  // non-numeric token: skip one char
        out[count++] = neg ? -v : v;
    }
    return count;
}

// ---------------------------------------------------------------------------
// P3 serialization: "r g b\n" per pixel.  Returns bytes written.
// ---------------------------------------------------------------------------
static inline char* put_u8(char* p, unsigned v) {
    if (v >= 100) { *p++ = '0' + v / 100; v %= 100; *p++ = '0' + v / 10; *p++ = '0' + v % 10; }
    else if (v >= 10) { *p++ = '0' + v / 10; *p++ = '0' + v % 10; }
    else { *p++ = '0' + v; }
    return p;
}

long jz_serialize_p3_pixels(const uint8_t* rgb, long npix, char* out) {
    char* p = out;
    for (long i = 0; i < npix; ++i) {
        p = put_u8(p, rgb[3 * i]);     *p++ = ' ';
        p = put_u8(p, rgb[3 * i + 1]); *p++ = ' ';
        p = put_u8(p, rgb[3 * i + 2]); *p++ = '\n';
    }
    return (long)(p - out);
}

// ---------------------------------------------------------------------------
// Byte stuffing: insert 0x00 after each 0xFF.  Returns output length.
// ---------------------------------------------------------------------------
long jz_byte_stuff(const uint8_t* in, long n, uint8_t* out) {
    long o = 0;
    for (long i = 0; i < n; ++i) {
        out[o++] = in[i];
        if (in[i] == 0xFF) out[o++] = 0x00;
    }
    return o;
}

// ---------------------------------------------------------------------------
// Splice per-block bitstrings (words MSB-first) into one stream, 1-padded to
// a byte boundary.  Returns total payload bits (before padding).
// out must hold ceil((sum(bits)+7)/8) bytes, zero-initialized by the caller.
// ---------------------------------------------------------------------------
long jz_splice_bits(const uint32_t* words, const int32_t* bits, long nblocks,
                    int words_per_block, uint8_t* out) {
    long bitpos = 0;
    for (long b = 0; b < nblocks; ++b) {
        const uint32_t* w = words + (long)b * words_per_block;
        int nb = bits[b];
        int widx = 0;
        while (nb > 0) {
            int take = nb < 32 ? nb : 32;
            uint32_t v = w[widx++];
            // write `take` MSBs of v at bitpos
            int sh = (int)(bitpos & 7);
            long byt = bitpos >> 3;
            // 64-bit staging: v's take bits, MSB-aligned to bit `sh` of out[byt]
            uint64_t stage = ((uint64_t)v << 32) >> sh;  // 64-bit window
            out[byt]     |= (uint8_t)(stage >> 56);
            out[byt + 1] |= (uint8_t)(stage >> 48);
            out[byt + 2] |= (uint8_t)(stage >> 40);
            out[byt + 3] |= (uint8_t)(stage >> 32);
            out[byt + 4] |= (uint8_t)(stage >> 24);
            bitpos += take;
            nb -= take;
        }
    }
    // 1-pad to byte boundary (T.81 F.1.2.3)
    int pad = (int)((8 - (bitpos & 7)) & 7);
    if (pad) {
        long byt = bitpos >> 3;
        out[byt] |= (uint8_t)((1 << pad) - 1);
    }
    return bitpos;
}

// ---------------------------------------------------------------------------
// Entropy decode frontend.
//
// Reads raw file bytes starting at the entropy-coded segment, handling byte
// stuffing (FF 00) and restart markers (FF D0-D7) inline.  Decodes all MCUs
// into per-component [nblocks, 64] int32 coefficient arrays (natural order,
// absolute DC).  Returns number of MCUs decoded, or -1 on format error.
//
// LUTs: per scan-component, 2^16-entry int32 arrays, value = (HUFFVAL<<8)|len,
// -1 for invalid windows (built host-side from the DHT tables).
// ---------------------------------------------------------------------------
struct BitReader {
    const uint8_t* d;
    long n;
    long pos;          // next byte index
    uint64_t acc;      // bit accumulator, MSB-first
    int nbits;         // valid bits in acc (top bits)
    bool at_marker;    // hit a non-RST marker
    int pending_rst;   // -1 none, else RST index 0-7 encountered during fill

    void init(const uint8_t* data, long len) {
        d = data; n = len; pos = 0; acc = 0; nbits = 0;
        at_marker = false; pending_rst = -1;
    }
    // fill accumulator to >= 25 bits (enough for a 16-bit peek + 11 extra)
    inline void fill() {
        while (nbits <= 56) {
            if (pos >= n) { acc |= 0; nbits += 8; continue; }  // 0-fill at EOF
            uint8_t b = d[pos];
            if (b == 0xFF) {
                if (pos + 1 < n) {
                    uint8_t b2 = d[pos + 1];
                    if (b2 == 0x00) {
                        pos += 2;
                        acc |= (uint64_t)0xFF << (56 - nbits);
                        nbits += 8;
                        continue;
                    }
                    if (b2 >= 0xD0 && b2 <= 0xD7) {
                        if (pending_rst < 0 && nbits == 0) {
                            // consume restart marker only when aligned & drained
                            pending_rst = b2 - 0xD0;
                            pos += 2;
                            continue;
                        }
                        // leave for later; stop filling real bits
                        nbits += 8;  // phantom zeros
                        continue;
                    }
                }
                at_marker = true;
                nbits += 8;  // phantom zeros beyond marker
                continue;
            }
            pos += 1;
            acc |= (uint64_t)b << (56 - nbits);
            nbits += 8;
        }
    }
    inline uint32_t peek16() { return (uint32_t)(acc >> 48); }
    inline void drop(int k) { acc <<= k; nbits -= k; }
    inline int32_t read_bits(int k) {
        if (k == 0) return 0;
        int32_t v = (int32_t)(acc >> (64 - k));
        acc <<= k; nbits -= k;
        return v;
    }
    // align to byte boundary and consume an expected RST marker
    inline bool sync_restart() {
        // drop partial bits in acc down to byte alignment of source:
        // simplest: reset accumulator to the current byte position state.
        // Discard whatever is buffered (decoder reached MCU boundary; any
        // remaining buffered bits are padding before the marker).
        acc = 0; nbits = 0;
        if (pending_rst >= 0) { pending_rst = -1; return true; }
        // scan forward for the marker
        while (pos + 1 < n) {
            if (d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7) {
                pos += 2;
                return true;
            }
            if (d[pos] == 0xFF && d[pos + 1] != 0x00) return false;  // real marker
            ++pos;
        }
        return false;
    }
};

int64_t jz_entropy_decode(
    const uint8_t* data, long nbytes,
    const int32_t* const* dc_luts,   // [ncomp] -> int32[65536]
    const int32_t* const* ac_luts,
    const int32_t* zigzag,           // ZZ[64]
    int ncomp,
    const int32_t* comp_h,           // per-component H sampling
    const int32_t* comp_v,
    int64_t n_mcus,
    int restart_interval,
    int16_t* const* out_coeffs       // [ncomp] -> int16[nblocks*64]
) {
    BitReader br;
    br.init(data, nbytes);
    int64_t pred[4] = {0, 0, 0, 0};
    int64_t blk_count[4] = {0, 0, 0, 0};
    int64_t since_restart = 0;

    for (int64_t m = 0; m < n_mcus; ++m) {
        if (restart_interval > 0 && since_restart == restart_interval) {
            if (!br.sync_restart()) return -2;
            pred[0] = pred[1] = pred[2] = pred[3] = 0;
            since_restart = 0;
        }
        for (int c = 0; c < ncomp; ++c) {
            const int32_t* dlut = dc_luts[c];
            const int32_t* alut = ac_luts[c];
            int nb = comp_h[c] * comp_v[c];
            for (int k = 0; k < nb; ++k) {
                int16_t* blk = out_coeffs[c] + blk_count[c] * 64;
                blk_count[c] += 1;
                // DC
                br.fill();
                int32_t e = dlut[br.peek16()];
                if (e < 0) return -3;
                int cat = e >> 8;
                br.drop(e & 0xFF);
                int32_t dc = 0;
                if (cat > 0) {
                    int32_t v = br.read_bits(cat);
                    if (!(v & (1 << (cat - 1)))) v -= (1 << cat) - 1;
                    dc = v;
                }
                pred[c] += dc;
                blk[0] = (int16_t)pred[c];
                // AC
                int kk = 1;
                while (kk < 64) {
                    br.fill();
                    int32_t ae = alut[br.peek16()];
                    if (ae < 0) return -4;
                    int rs = ae >> 8;
                    br.drop(ae & 0xFF);
                    int run = rs >> 4, s = rs & 0x0F;
                    if (s == 0) {
                        if (run == 15) { kk += 16; continue; }  // ZRL
                        break;                                   // EOB
                    }
                    kk += run;
                    if (kk > 63) return -5;
                    int32_t v = br.read_bits(s);
                    if (!(v & (1 << (s - 1)))) v -= (1 << s) - 1;
                    blk[zigzag[kk]] = (int16_t)v;
                    ++kk;
                }
            }
        }
        since_restart += 1;
    }
    return n_mcus;
}

// ---------------------------------------------------------------------------
// Fast serial entropy decode over DESTUFFED data (restart-free streams).
//
// The general decoder above pays a stuffing/marker branch per input byte in
// fill(); destuffing once (jz_destuff, memcpy-speed) lets the bit reader be
// a branchless 64-bit window load (one unaligned load + bswap per Huffman
// symbol).  Measured ~3x the general decoder on the 2048x2048 noise stream.
// Semantics identical: zero-fill past end of data (the reference's decoder
// treats post-marker reads as zeros), same sign extension and de-zigzag.
// ---------------------------------------------------------------------------
namespace fastbits {

// Accumulator reader over destuffed data that the CALLER padded with >= 8
// zero bytes past `n` -- the hot refill is one unaligned 32-bit load with
// no bounds or stuffing branches (past-end reads land in the zero pad,
// matching the general decoder's zero-fill-at-EOF semantics).
struct Reader {
    const uint8_t* d;
    int64_t pos = 0;       // next byte (may run into the zero pad)
    uint64_t acc = 0;      // MSB-first bit accumulator
    int nbits = 0;

    inline void fill() {
        if (nbits <= 32) {
            uint32_t w;
            std::memcpy(&w, d + pos, 4);
            acc |= (uint64_t)__builtin_bswap32(w) << (32 - nbits);
            pos += 4;
            nbits += 32;
        }
    }
    inline uint32_t peek16() const { return (uint32_t)(acc >> 48); }
    inline void drop(int k) { acc <<= k; nbits -= k; }
    inline int64_t bitpos() const { return pos * 8 - nbits; }
};

}  // namespace fastbits

int64_t jz_entropy_decode_fast(
    const uint8_t* destuffed, long nbytes,   // + >=8 zero pad bytes after
    const int32_t* const* dc_luts, const int32_t* const* ac_luts,
    const int32_t* zigzag, int ncomp,
    const int32_t* comp_h, const int32_t* comp_v,
    int64_t n_mcus,
    int16_t* const* out_coeffs
) {
    fastbits::Reader br{destuffed};
    int64_t pred[4] = {0, 0, 0, 0};
    int64_t blk_count[4] = {0, 0, 0, 0};
    const int64_t bit_limit = (int64_t)nbytes * 8 + 64;

    for (int64_t m = 0; m < n_mcus; ++m) {
        for (int c = 0; c < ncomp; ++c) {
            const int32_t* dlut = dc_luts[c];
            const int32_t* alut = ac_luts[c];
            int nb = comp_h[c] * comp_v[c];
            for (int k = 0; k < nb; ++k) {
                if (br.bitpos() > bit_limit) return -6;  // truncated stream
                int16_t* blk = out_coeffs[c] + blk_count[c] * 64;
                blk_count[c] += 1;
                // DC
                br.fill();
                int32_t e = dlut[br.peek16()];
                if (e < 0) return -3;
                int cat = e >> 8;
                br.drop(e & 0xFF);
                if (cat > 0) {
                    br.fill();
                    int32_t v = (int32_t)(br.acc >> (64 - cat));
                    br.drop(cat);
                    if (!(v & (1 << (cat - 1)))) v -= (1 << cat) - 1;
                    pred[c] += v;
                }
                blk[0] = (int16_t)pred[c];
                // AC
                int kk = 1;
                while (kk < 64) {
                    br.fill();
                    int32_t ae = alut[br.peek16()];
                    if (ae < 0) return -4;
                    int rs = ae >> 8;
                    br.drop(ae & 0xFF);
                    int run = rs >> 4, s = rs & 0x0F;
                    if (s == 0) {
                        if (run == 15) { kk += 16; continue; }  // ZRL
                        break;                                   // EOB
                    }
                    kk += run;
                    if (kk > 63) return -5;
                    br.fill();
                    int32_t v = (int32_t)(br.acc >> (64 - s));
                    br.drop(s);
                    if (!(v & (1 << (s - 1)))) v -= (1 << s) - 1;
                    blk[zigzag[kk]] = (int16_t)v;
                    ++kk;
                }
            }
        }
    }
    return n_mcus;
}

// ---------------------------------------------------------------------------
// Index scan: pass 1 of the index-assisted parallel decode of RESTART-FREE
// streams (SURVEY 2.7 option (b), the standard GPU-JPEG two-pass shape).
//
// Walks the destuffed stream serially decoding ONLY code lengths (plus DC
// extra bits, which feed the predictors), recording every k_mcus MCUs:
// the bit offset of the pseudo-segment start and the 3 absolute DC
// predictor values at that point.  Pass 2 re-decodes all pseudo-segments
// in parallel on the device (ops/entropy_decode.decode_segments with
// per-lane skip0 bits + preds0) -- the serial dependency collapses to
// this cheap length-only scan.
//
// Returns number of index entries written, or negative on a format error.
// ---------------------------------------------------------------------------
int64_t jz_index_scan(
    const uint8_t* destuffed, long nbytes,   // + >=8 zero pad bytes after
    const int32_t* const* dc_luts, const int32_t* const* ac_luts,
    int ncomp, const int32_t* comp_h, const int32_t* comp_v,
    int64_t n_mcus, int64_t k_mcus,
    int64_t* out_bitoffs,                    // [ceil(n_mcus/k_mcus)]
    int32_t* out_preds                       // [ceil(n_mcus/k_mcus) * 3]
) {
    fastbits::Reader br{destuffed};
    int64_t pred[4] = {0, 0, 0, 0};
    const int64_t bit_limit = (int64_t)nbytes * 8 + 64;
    int64_t nidx = 0;

    for (int64_t m = 0; m < n_mcus; ++m) {
        if (m % k_mcus == 0) {
            out_bitoffs[nidx] = br.bitpos();
            for (int c = 0; c < 3; ++c)
                out_preds[nidx * 3 + c] = (int32_t)pred[c];
            ++nidx;
        }
        for (int c = 0; c < ncomp; ++c) {
            const int32_t* dlut = dc_luts[c];
            const int32_t* alut = ac_luts[c];
            int nb = comp_h[c] * comp_v[c];
            for (int k = 0; k < nb; ++k) {
                if (br.bitpos() > bit_limit) return -6;
                br.fill();
                int32_t e = dlut[br.peek16()];
                if (e < 0) return -3;
                int cat = e >> 8;
                br.drop(e & 0xFF);
                if (cat > 0) {
                    br.fill();
                    int32_t v = (int32_t)(br.acc >> (64 - cat));
                    br.drop(cat);
                    if (!(v & (1 << (cat - 1)))) v -= (1 << cat) - 1;
                    pred[c] += v;
                }
                int kk = 1;
                while (kk < 64) {
                    br.fill();
                    int32_t ae = alut[br.peek16()];
                    if (ae < 0) return -4;
                    int rs = ae >> 8;
                    br.drop(ae & 0xFF);
                    int run = rs >> 4, s = rs & 0x0F;
                    if (s == 0) {
                        if (run == 15) { kk += 16; continue; }
                        break;
                    }
                    kk += run;
                    if (kk > 63) return -5;
                    br.fill();
                    br.drop(s);                // length only: skip extras
                    ++kk;
                }
            }
        }
    }
    return nidx;
}

// ---------------------------------------------------------------------------
// Copy pseudo-segment byte windows into fixed-stride rows (pass-2 prep for
// the index-assisted decode): row s = destuffed[bitoffs[s]/8 ...), zero-
// padded.  Returns max row byte length, or -(s+1) on stride overflow.
// ---------------------------------------------------------------------------
long jz_copy_bit_windows(const uint8_t* destuffed, long nbytes,
                         const int64_t* bitoffs, long nseg,
                         uint8_t* out, long L) {
    long mx = 0;
    for (long s = 0; s < nseg; ++s) {
        long b0 = bitoffs[s] >> 3;
        long b1 = (s + 1 < nseg) ? ((bitoffs[s + 1] >> 3) + 8) : nbytes;
        if (b1 > nbytes) b1 = nbytes;
        long n = b1 - b0;
        if (n > L) return -(s + 1);
        std::memcpy(out + s * L, destuffed + b0, (size_t)n);
        if (n > mx) mx = n;
    }
    return mx;
}

// ---------------------------------------------------------------------------
// Thread-parallel entropy decode over restart segments.
//
// Restart markers reset the DC predictors and byte-align the stream
// (T.81 F.2.1.3.1; reference jpezy_decoder.hpp:152-163), so each segment is
// independently decodable -- the in-format analog of checkpointed resume.
// seg_offsets[s] = byte offset of segment s's entropy data (segment 0 at 0);
// segment s covers MCUs [s*ri, min((s+1)*ri, n_mcus)).
// ---------------------------------------------------------------------------
int64_t jz_entropy_decode_mt(
    const uint8_t* data, long nbytes,
    const int64_t* seg_offsets, long nseg,
    const int32_t* const* dc_luts, const int32_t* const* ac_luts,
    const int32_t* zigzag, int ncomp,
    const int32_t* comp_h, const int32_t* comp_v,
    int64_t n_mcus, int restart_interval,
    int16_t* const* out_coeffs, int nthreads
) {
    if (nseg <= 1 || restart_interval <= 0) {
        return jz_entropy_decode(data, nbytes, dc_luts, ac_luts, zigzag,
                                 ncomp, comp_h, comp_v, n_mcus,
                                 restart_interval, out_coeffs);
    }
    if (nthreads <= 0) {
        nthreads = (int)std::thread::hardware_concurrency();
        if (nthreads <= 0) nthreads = 4;
    }
    std::vector<int64_t> results(nseg, 0);

    auto work = [&](long s0, long s1) {
        for (long s = s0; s < s1; ++s) {
            int64_t mcu0 = (int64_t)s * restart_interval;
            int64_t mcu1 = mcu0 + restart_interval;
            if (mcu1 > n_mcus) mcu1 = n_mcus;
            if (mcu0 >= mcu1) { results[s] = 0; continue; }
            // per-segment output base pointers
            int16_t* bases[4];
            for (int c = 0; c < ncomp; ++c) {
                int64_t blocks_before = mcu0 * comp_h[c] * comp_v[c];
                bases[c] = out_coeffs[c] + blocks_before * 64;
            }
            long off = seg_offsets[s];
            results[s] = jz_entropy_decode(
                data + off, nbytes - off, dc_luts, ac_luts, zigzag,
                ncomp, comp_h, comp_v, mcu1 - mcu0, /*ri=*/0, bases);
        }
    };

    long per = (nseg + nthreads - 1) / nthreads;
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
        long s0 = (long)t * per;
        long s1 = s0 + per < nseg ? s0 + per : nseg;
        if (s0 >= s1) break;
        threads.emplace_back(work, s0, s1);
    }
    for (auto& th : threads) th.join();

    int64_t total = 0;
    for (long s = 0; s < nseg; ++s) {
        int64_t expect = restart_interval;
        if ((int64_t)(s + 1) * restart_interval > n_mcus)
            expect = n_mcus - (int64_t)s * restart_interval;
        if (results[s] != expect) return -(100 + s);
        total += results[s];
    }
    return total;
}

// ---------------------------------------------------------------------------
// Sparsify dense coefficient blocks for compact host->device upload.
//
// Per block: a 64-bit nonzero mask (2x uint32, bit j = natural index j) and
// up to `k` values in index order.  Blocks with more than k nonzeros are
// listed in an overflow index array (their dense rows are uploaded as-is).
// Returns the overflow count.
// ---------------------------------------------------------------------------
// int8 value variant: values are one byte each (quantized baseline
// coefficients rarely exceed +-127); blocks with any |coef| > 127 OR more
// than k nonzeros go to the overflow list (dense int16 rows).  ~35% fewer
// upload bytes than the int16 variant for typical content.
long jz_sparsify_i8(const int16_t* dense, long nblocks, int k,
                    uint32_t* mask_lo, uint32_t* mask_hi,
                    int8_t* vals,           // [nblocks, k]
                    int64_t* overflow_idx, long overflow_cap) {
    long novf = 0;
    for (long b = 0; b < nblocks; ++b) {
        const int16_t* blk = dense + b * 64;
        uint32_t lo = 0, hi = 0;
        int cnt = 0;
        bool wide = false;
        int8_t* v = vals + (long)b * k;
        for (int j = 0; j < 64; ++j) {
            int16_t x = blk[j];
            if (x != 0) {
                if (x < -128 || x > 127) wide = true;
                if (cnt < k) v[cnt] = (int8_t)x;
                ++cnt;
                if (j < 32) lo |= 1u << j; else hi |= 1u << (j - 32);
            }
        }
        if (cnt > k || wide) {
            // overflow: mask cleared so the dense scatter row wins alone
            mask_lo[b] = 0;
            mask_hi[b] = 0;
            for (int j = 0; j < k; ++j) v[j] = 0;
            if (novf < overflow_cap) overflow_idx[novf] = b;
            ++novf;
        } else {
            mask_lo[b] = lo;
            mask_hi[b] = hi;
        }
    }
    return novf;
}

long jz_sparsify(const int16_t* dense, long nblocks, int k,
                 uint32_t* mask_lo, uint32_t* mask_hi,
                 int16_t* vals,            // [nblocks, k]
                 int64_t* overflow_idx, long overflow_cap) {
    long novf = 0;
    for (long b = 0; b < nblocks; ++b) {
        const int16_t* blk = dense + b * 64;
        uint32_t lo = 0, hi = 0;
        int cnt = 0;
        int16_t* v = vals + (long)b * k;
        for (int j = 0; j < 64; ++j) {
            if (blk[j] != 0) {
                if (cnt < k) v[cnt] = blk[j];
                ++cnt;
                if (j < 32) lo |= 1u << j; else hi |= 1u << (j - 32);
            }
        }
        mask_lo[b] = lo;
        mask_hi[b] = hi;
        if (cnt > k) {
            if (novf < overflow_cap) overflow_idx[novf] = b;
            ++novf;
        }
    }
    return novf;
}

// ---------------------------------------------------------------------------
// YCC 4:2:0 -> interleaved RGB (the reference's decode tail, in double
// precision: to_r/to_g/to_b jpezy_decoder.hpp:567-578, revise_value
// :672-676, nearest-neighbor chroma duplication :519-524).  Used when the
// device returns native-resolution planes to halve the device->host
// transfer; bit-identical to the device color path in exact mode.
// y: [H, W]; cb, cr: [H/2, W/2]; out: [H, W, 3].
// ---------------------------------------------------------------------------
// Encode-side color transport: interleaved RGB [N, H, W, 3] u8 ->
// level-shifted Y [N, H, W] i8 + 4:2:0 top-left-decimated Cb/Cr
// [N, H/2, W/2] i8.  Same double-precision expression order and int
// truncation as the reference's RGB::Y/Cb/Cr (jpezy_encoder.hpp:245-256),
// with the chroma decimation (jpezy_encoder.hpp:116-143) applied before
// the chroma arithmetic (pointwise, so the order is equivalent).
// H and W must be even.  Multithreaded over rows.
void jz_rgb_to_ycc420(const uint8_t* rgb, long N, long H, long W,
                      int8_t* y, int8_t* cb, int8_t* cr, int nthreads) {
    if (nthreads <= 0) {
        nthreads = (int)std::thread::hardware_concurrency();
        if (nthreads <= 0) nthreads = 4;
    }
    const long rows = N * H;
    const long cw = W / 2;
    auto work = [&](long r0, long r1) {
        for (long r = r0; r < r1; ++r) {
            const uint8_t* p = rgb + r * W * 3;
            int8_t* yrow = y + r * W;
            for (long c = 0; c < W; ++c) {
                double rf = (double)p[3 * c];
                double gf = (double)p[3 * c + 1];
                double bf = (double)p[3 * c + 2];
                yrow[c] = (int8_t)(int32_t)(
                    (0.2990 * rf) + (0.5870 * gf) + (0.1140 * bf) - 128.0);
            }
            if ((r % H) % 2 == 0) {  // top-left of each 2x2
                long n = r / H, hr = (r % H) / 2;
                int8_t* cbrow = cb + (n * (H / 2) + hr) * cw;
                int8_t* crrow = cr + (n * (H / 2) + hr) * cw;
                for (long c = 0; c < cw; ++c) {
                    double rf = (double)p[6 * c];
                    double gf = (double)p[6 * c + 1];
                    double bf = (double)p[6 * c + 2];
                    cbrow[c] = (int8_t)(int32_t)(
                        -(0.1687 * rf) - (0.3313 * gf) + (0.5000 * bf));
                    crrow[c] = (int8_t)(int32_t)(
                        (0.5000 * rf) - (0.4187 * gf) - (0.0813 * bf));
                }
            }
        }
    };
    if (nthreads == 1 || rows < 64) {
        work(0, rows);
        return;
    }
    long per = (rows + nthreads - 1) / nthreads;
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
        long r0 = t * per, r1 = r0 + per < rows ? r0 + per : rows;
        if (r0 >= r1) break;
        threads.emplace_back(work, r0, r1);
    }
    for (auto& th : threads) th.join();
}

// Batched, multithreaded variant: [N, H, W] planes -> [N, H, W, 3] RGB.
void jz_ycc420_to_rgb_batch(const uint8_t* y, const uint8_t* cb,
                            const uint8_t* cr, long N, long H, long W,
                            uint8_t* out, int nthreads) {
    if (nthreads <= 0) {
        nthreads = (int)std::thread::hardware_concurrency();
        if (nthreads <= 0) nthreads = 4;
    }
    const long rows = N * H;
    const long cw = W / 2, chh = H / 2;
    auto work = [&](long r0, long r1) {
        for (long r = r0; r < r1; ++r) {
            long n = r / H, hr = r % H;
            const uint8_t* yrow = y + r * W;
            const uint8_t* cbrow = cb + (n * chh + hr / 2) * cw;
            const uint8_t* crrow = cr + (n * chh + hr / 2) * cw;
            uint8_t* o = out + r * W * 3;
            for (long c = 0; c < W; ++c) {
                double yy = (double)yrow[c];
                double u = (double)cbrow[c / 2];
                double v = (double)crrow[c / 2];
                double rr = yy + (v - 128.0) * 1.4020;
                double gg = yy - (u - 128.0) * 0.3441 - (v - 128.0) * 0.7139;
                double bb = yy + (u - 128.0) * 1.7718;
                o[3 * c] = rr < 0.0 ? 0 : rr > 255.0 ? 255 : (uint8_t)rr;
                o[3 * c + 1] = gg < 0.0 ? 0 : gg > 255.0 ? 255 : (uint8_t)gg;
                o[3 * c + 2] = bb < 0.0 ? 0 : bb > 255.0 ? 255 : (uint8_t)bb;
            }
        }
    };
    if (nthreads == 1 || rows < 64) {
        work(0, rows);
        return;
    }
    long per = (rows + nthreads - 1) / nthreads;
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
        long r0 = t * per, r1 = r0 + per < rows ? r0 + per : rows;
        if (r0 >= r1) break;
        threads.emplace_back(work, r0, r1);
    }
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Host fallback codec: the transform + entropy-encode hot loops in C++ so a
// one-shot CLI run on a small image never has to initialize an accelerator
// backend (the reference does a 512x512 encode in 42 ms; starting JAX and
// compiling the device program alone costs seconds).
//
// Numerics contract: bit-identical to the numpy oracle (jpezy_tpu/codec/
// oracle.py), which pins the reference's float64 semantics -- the cosine
// term tables and the exact accumulation ORDER are passed in from Python so
// both paths share constants, and the build uses -ffp-contract=off so GCC
// cannot fuse a*b+c into FMA (which would round differently from numpy).
// Referents: forward DCT jpezy_encoder.hpp:146-166, quantization :168-172,
// entropy encode :174-225, IDCT jpezy_decoder.hpp:652-670.
// ---------------------------------------------------------------------------

// Forward DCT + quantization, oracle term order.
// pic: [B, 64] int8 level-shifted spatial blocks;
// c1/c2: [64, 64] doubles, term k's factors per output ij (oracle
// _FWD_C1/_FWD_C2); cu8: [8] doubles (1/sqrt2, 1, ...);
// qt: [64] int32 quant divisors; out: [B, 64] int32.
void jz_fdct_quant(const int8_t* pic, long B,
                   const double* c1, const double* c2, const double* cu8,
                   const int32_t* qt, int32_t* out, int nthreads) {
    if (nthreads <= 0) {
        nthreads = (int)std::thread::hardware_concurrency();
        if (nthreads <= 0) nthreads = 4;
    }
    auto work = [&](long b0, long b1) {
        double s[64];
        for (long b = b0; b < b1; ++b) {
            const int8_t* p = pic + b * 64;
            for (int ij = 0; ij < 64; ++ij) s[ij] = 0.0;
            for (int k = 0; k < 64; ++k) {       // reference (y, x) raster
                double pk = (double)p[k];
                const double* a = c1 + k * 64;
                const double* d = c2 + k * 64;
                for (int ij = 0; ij < 64; ++ij) s[ij] += (pk * a[ij]) * d[ij];
            }
            int32_t* o = out + b * 64;
            for (int ij = 0; ij < 64; ++ij) {
                double r = ((s[ij] * cu8[ij % 8]) * cu8[ij / 8]) / 4.0;
                int32_t v = (int32_t)r;          // C trunc toward zero
                o[ij] = v / qt[ij];              // truncating int division
            }
        }
    };
    if (nthreads == 1 || B < 64) { work(0, B); return; }
    long per = (B + nthreads - 1) / nthreads;
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
        long b0 = (long)t * per, b1 = b0 + per < B ? b0 + per : B;
        if (b0 >= b1) break;
        threads.emplace_back(work, b0, b1);
    }
    for (auto& th : threads) th.join();
}

// Dequantize + inverse DCT, oracle term order (v outer, u inner).
// coeffs: [B, 64] int16 natural order; cucv: [64] doubles (oracle
// _INV_CUCV); c1/c2: [64, 64] (oracle _INV_C1/_INV_C2); out [B, 64] int32
// spatial with the +level shift.
void jz_idct_dequant(const int16_t* coeffs, long B, const int32_t* qt,
                     const double* cucv, const double* c1, const double* c2,
                     int level, int32_t* out, int nthreads) {
    if (nthreads <= 0) {
        nthreads = (int)std::thread::hardware_concurrency();
        if (nthreads <= 0) nthreads = 4;
    }
    auto work = [&](long b0, long b1) {
        double s[64];
        for (long b = b0; b < b1; ++b) {
            const int16_t* p = coeffs + b * 64;
            for (int yx = 0; yx < 64; ++yx) s[yx] = 0.0;
            for (int k = 0; k < 64; ++k) {
                double dk = cucv[k] * (double)((int32_t)p[k] * qt[k]);
                const double* a = c1 + k * 64;
                const double* d = c2 + k * 64;
                for (int yx = 0; yx < 64; ++yx) s[yx] += (dk * a[yx]) * d[yx];
            }
            int32_t* o = out + b * 64;
            for (int yx = 0; yx < 64; ++yx)
                o[yx] = (int32_t)(s[yx] / 4.0 + (double)level);
        }
    };
    if (nthreads == 1 || B < 64) { work(0, B); return; }
    long per = (B + nthreads - 1) / nthreads;
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
        long b0 = (long)t * per, b1 = b0 + per < B ? b0 + per : B;
        if (b0 >= b1) break;
        threads.emplace_back(work, b0, b1);
    }
    for (auto& th : threads) th.join();
}

// Serial Huffman entropy encoder with inline byte stuffing and restart
// markers.  Tables are packed (code << 8) | size, keyed by DC category /
// AC symbol byte (run<<4 | s; EOB = 0x00, ZRL = 0xF0).
// Histogram mode (out == NULL): count symbols into hist[4*256]
// (Y-DC, Y-AC, C-DC, C-AC) instead of emitting -- pass 1 of the
// -optimize two-pass encode.
// Returns bytes written (0 in histogram mode), or -1 on outcap overflow.
namespace hostenc {

struct BitWriter {
    uint8_t* out; long cap; long o = 0;
    uint64_t acc = 0; int nbits = 0; bool overflow = false;

    inline void put(uint32_t code, int n) {
        if (n == 0) return;
        acc |= (uint64_t)code << (64 - nbits - n);
        nbits += n;
        while (nbits >= 8) {
            if (o + 2 > cap) { overflow = true; nbits = 0; acc = 0; return; }
            uint8_t b = (uint8_t)(acc >> 56);
            out[o++] = b;
            if (b == 0xFF) out[o++] = 0x00;  // stuffing
            acc <<= 8; nbits -= 8;
        }
    }
    // 1-pad to a byte boundary (T.81 F.1.2.3)
    inline void pad1() {
        int p = (8 - (nbits & 7)) & 7;
        if (p) put((1u << p) - 1, p);
    }
};

static inline int mag_category(int32_t v) {
    uint32_t a = v < 0 ? (uint32_t)(-(int64_t)v) : (uint32_t)v;
    return a ? 32 - __builtin_clz(a) : 0;
}

static inline void enc_block(BitWriter* bw, const int32_t* blk, int64_t* pred,
                             const uint32_t* dct, const uint32_t* act,
                             const int32_t* zz,
                             uint32_t* hdc, uint32_t* hac) {
    int32_t diff = (int32_t)(blk[0] - *pred);
    *pred = blk[0];
    int cat = mag_category(diff);
    if (hdc) {
        ++hdc[cat];
    } else {
        uint32_t e = dct[cat];
        bw->put(e >> 8, (int)(e & 0xFF));
        if (cat) {
            int32_t x = diff < 0 ? diff - 1 : diff;  // one's-complement trick
            bw->put((uint32_t)x & ((1u << cat) - 1), cat);
        }
    }
    int run = 0;
    for (int k = 1; k < 64; ++k) {
        int32_t v = blk[zz[k]];
        if (v == 0) { ++run; continue; }
        while (run > 15) {
            if (hac) ++hac[0xF0];
            else { uint32_t e = act[0xF0]; bw->put(e >> 8, (int)(e & 0xFF)); }
            run -= 16;
        }
        int s = mag_category(v);
        int sym = (run << 4) | s;
        if (hac) {
            ++hac[sym];
        } else {
            uint32_t e = act[sym];
            bw->put(e >> 8, (int)(e & 0xFF));
            int32_t x = v < 0 ? v - 1 : v;
            bw->put((uint32_t)x & ((1u << s) - 1), s);
        }
        run = 0;
    }
    if (run > 0) {  // trailing zeros -> EOB (never ZRL), jpezy_encoder.hpp:219
        if (hac) ++hac[0x00];
        else { uint32_t e = act[0x00]; bw->put(e >> 8, (int)(e & 0xFF)); }
    }
}

}  // namespace hostenc

int64_t jz_entropy_encode(
    const int32_t* yq,                // [nmcu*4, 64] natural order
    const int32_t* cbq,               // [nmcu, 64]
    const int32_t* crq,               // [nmcu, 64]
    long nmcu, int restart_interval,
    const int32_t* zigzag,
    const uint32_t* ydc, const uint32_t* yac,   // packed (code<<8)|size
    const uint32_t* cdc, const uint32_t* cac,
    uint8_t* out, long outcap,        // NULL -> histogram mode
    uint32_t* hist                    // [4*256] or NULL
) {
    hostenc::BitWriter bw{out, outcap};
    uint32_t* hydc = nullptr; uint32_t* hyac = nullptr;
    uint32_t* hcdc = nullptr; uint32_t* hcac = nullptr;
    bool counting = out == nullptr;
    if (counting) {
        hydc = hist; hyac = hist + 256; hcdc = hist + 512; hcac = hist + 768;
    }
    int64_t pred[3] = {0, 0, 0};
    long since = 0, seg = 0;
    for (long m = 0; m < nmcu; ++m) {
        if (restart_interval > 0 && since == restart_interval) {
            if (!counting) {
                bw.pad1();
                if (bw.o + 2 > outcap) return -1;
                out[bw.o++] = 0xFF;                  // RSTn: raw marker,
                out[bw.o++] = (uint8_t)(0xD0 + (seg % 8));  // never stuffed
            }
            pred[0] = pred[1] = pred[2] = 0;
            since = 0; ++seg;
        }
        for (int k = 0; k < 4; ++k)
            hostenc::enc_block(&bw, yq + (m * 4 + k) * 64, &pred[0],
                               ydc, yac, zigzag, hydc, hyac);
        hostenc::enc_block(&bw, cbq + m * 64, &pred[1], cdc, cac, zigzag,
                           hcdc, hcac);
        hostenc::enc_block(&bw, crq + m * 64, &pred[2], cdc, cac, zigzag,
                           hcdc, hcac);
        ++since;
    }
    if (counting) return 0;
    bw.pad1();
    if (bw.overflow) return -1;
    return bw.o;
}

// Reference-exact color tail on FULL-RESOLUTION int32 planes (the host
// codec's decode path): double math in the oracle's exact expression
// order, truncation toward zero, clamp AFTER color conversion
// (jpezy_decoder.hpp:567-578, 672-676).  Bit-identical to
// codec/oracle.ycc_to_rgb (requires -ffp-contract=off).
void jz_ycc_to_rgb_i32(const int32_t* y, const int32_t* cb,
                       const int32_t* cr, long H, long W, uint8_t* out,
                       int nthreads) {
    if (nthreads <= 0) {
        nthreads = (int)std::thread::hardware_concurrency();
        if (nthreads <= 0) nthreads = 4;
    }
    auto clamp8 = [](double v) -> uint8_t {
        double t = std::trunc(v);
        return t < 0.0 ? 0 : t > 255.0 ? 255 : (uint8_t)t;
    };
    auto work = [&](long r0, long r1) {
        for (long r = r0; r < r1; ++r) {
            const int32_t* yr = y + r * W;
            const int32_t* ur = cb + r * W;
            const int32_t* vr = cr + r * W;
            uint8_t* o = out + r * W * 3;
            for (long c = 0; c < W; ++c) {
                double yf = (double)yr[c];
                double uf = (double)ur[c];
                double vf = (double)vr[c];
                o[3 * c]     = clamp8(yf + (vf - 128.0) * 1.4020);
                o[3 * c + 1] = clamp8(yf - (uf - 128.0) * 0.3441
                                         - (vf - 128.0) * 0.7139);
                o[3 * c + 2] = clamp8(yf + (uf - 128.0) * 1.7718);
            }
        }
    };
    if (nthreads == 1 || H < 64) { work(0, H); return; }
    long per = (H + nthreads - 1) / nthreads;
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
        long r0 = (long)t * per, r1 = r0 + per < H ? r0 + per : H;
        if (r0 >= r1) break;
        threads.emplace_back(work, r0, r1);
    }
    for (auto& th : threads) th.join();
}

void jz_ycc420_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                      long H, long W, uint8_t* out) {
    const long cw = (W + 1) / 2;  // chroma plane is ceil(W/2) wide
    for (long r = 0; r < H; ++r) {
        const uint8_t* yrow = y + r * W;
        const uint8_t* cbrow = cb + (r / 2) * cw;
        const uint8_t* crrow = cr + (r / 2) * cw;
        uint8_t* o = out + r * W * 3;
        for (long c = 0; c < W; ++c) {
            double yy = (double)yrow[c];
            double u = (double)cbrow[c / 2];
            double v = (double)crrow[c / 2];
            double rr = yy + (v - 128.0) * 1.4020;
            double gg = yy - (u - 128.0) * 0.3441 - (v - 128.0) * 0.7139;
            double bb = yy + (u - 128.0) * 1.7718;
            o[3 * c] = rr < 0.0 ? 0 : rr > 255.0 ? 255 : (uint8_t)rr;
            o[3 * c + 1] = gg < 0.0 ? 0 : gg > 255.0 ? 255 : (uint8_t)gg;
            o[3 * c + 2] = bb < 0.0 ? 0 : bb > 255.0 ? 255 : (uint8_t)bb;
        }
    }
}

}  // extern "C"
