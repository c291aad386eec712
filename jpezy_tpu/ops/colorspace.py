"""Color conversion ops (device, jnp).

Batched over whole planes; the reference does this per pixel inside the MCU
loop (src/encoder/jpezy_encoder.hpp:244-263, src/decoder/jpezy_decoder.hpp:567-578).
XLA fuses these elementwise stages into neighboring ops.

dtype float32 is the fast path; float64 ("exact" mode) reproduces the
reference's double-precision truncation bit-for-bit.
"""
from __future__ import annotations

import math

import jax.numpy as jnp


def rgb_to_ycc(r, g, b, dtype=jnp.float32):
    """RGB -> (Y-128, Cb, Cr) with C int() truncation.

    Expression order matches jpezy_encoder.hpp:245-256 so float64 mode is
    bit-exact vs the reference.
    """
    rf = r.astype(dtype)
    gf = g.astype(dtype)
    bf = b.astype(dtype)

    def mul(v, c):                      # 8-bit samples
        return _scale(v, c, dtype, 8)

    y = (mul(rf, 0.2990) + mul(gf, 0.5870) + mul(bf, 0.1140)
         - 128.0).astype(jnp.int32)
    cb = (-mul(rf, 0.1687) - mul(gf, 0.3313) + mul(bf, 0.5000)).astype(
        jnp.int32)
    cr = (mul(rf, 0.5000) - mul(gf, 0.4187) - mul(bf, 0.0813)).astype(
        jnp.int32)
    return y, cb, cr


def _scale(v, c: float, dtype, int_bits: int):
    """v * c, in float64 as exact_scale(v, c, int_bits)."""
    return exact_scale(v, c, int_bits) if dtype == jnp.float64 else v * c


def exact_scale(v, c: float, int_bits: int):
    """fl(v * c) for integer-valued float64 v with |v| < 2**int_bits, in a
    form no compiler can round differently: c splits into hi + lo so that
    v * hi and v * lo are both exact, and their one rounded sum is the
    correctly rounded product.  A plain v * c feeding an add may be
    contracted into an FMA (XLA allows it on every backend), which skips
    the product's rounding and breaks parity with the reference's double
    math."""
    hi = _split_hi(c, 53 - int_bits)
    return v * hi + v * (c - hi)


def _split_hi(c: float, bits: int) -> float:
    """c with all but its top `bits` significant bits cleared (exact)."""
    m, e = math.frexp(c)
    return math.ldexp(math.floor(m * 2.0 ** bits), e - bits)


def ycc_to_rgb(y, cb, cr, dtype=jnp.float32):
    """(Y+128-domain, Cb, Cr) int samples -> clamped uint8 RGB.

    Matches jpezy_decoder.hpp:567-578 (to_r/to_g/to_b) with revise_value
    clamping (:672-676): <0 -> 0, >255 -> 255, else truncate toward zero.
    """
    yf = y.astype(dtype)
    cbf = cb.astype(dtype)
    crf = cr.astype(dtype)

    def mul(v, c):          # IDCT samples stay far below 2**21
        return _scale(v, c, dtype, 21)

    r = yf + mul(crf - 128.0, 1.4020)
    g = yf - mul(cbf - 128.0, 0.3441) - mul(crf - 128.0, 0.7139)
    b = yf + mul(cbf - 128.0, 1.7718)

    def clamp(v):
        return jnp.clip(jnp.trunc(v), 0.0, 255.0).astype(jnp.uint8)

    return clamp(r), clamp(g), clamp(b)


def clamp_gray(y, dtype=jnp.float32):
    """GRAY_MODE output: clamp luma directly (jpezy_decoder.hpp:560-562)."""
    return jnp.clip(jnp.trunc(y.astype(dtype)), 0.0, 255.0).astype(jnp.uint8)
