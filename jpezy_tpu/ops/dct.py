"""8x8 DCT-II / IDCT as single 64x64 matmuls (device, jnp).

Instead of the reference's O(64^2) scalar quad loop per block
(src/encoder/jpezy_encoder.hpp:146-166, src/decoder/jpezy_decoder.hpp:
652-670), all blocks are flattened to [B, 64] and run as one
[B, 64] @ [64, 64] matrix product.  The separable basis is folded into a
single matrix M[(u,v), (y,x)] = cu*cv/4 * cos((2y+1)u pi/16)
cos((2x+1)v pi/16), so the contraction dimension is 64 (vs 8 for the
separable two-pass form).

float32 is the fast path, pinned to Precision.HIGHEST: a GPU may otherwise
run a float32 product in TF32 (~10 mantissa bits), and DCT sums of 8-bit
samples reach the thousands, so TF32 would break the fast path's envelope.
float64 reproduces the reference's double-precision int() truncation
(bit-exact parity testing and `precision="exact"`): its ordered sums keep
every product rounded on its own (see `rounded`).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _basis64() -> tuple[np.ndarray, np.ndarray]:
    """Forward and inverse 64x64 DCT matrices (float64 masters)."""
    u = np.arange(8, dtype=np.float64)[:, None]
    x = np.arange(8, dtype=np.float64)[None, :]
    cos = np.cos((2.0 * x + 1.0) * u * np.pi / 16.0)  # COS[u, x]
    c = np.ones(8, dtype=np.float64)
    c[0] = 1.0 / np.sqrt(2.0)
    scale = np.outer(c, c) / 4.0  # cu*cv/4

    # forward: D[u,v] = scale[u,v] * sum_{y,x} X[y,x] COS[u,y] COS[v,x]
    fwd = np.einsum("uy,vx->uvyx", cos, cos) * scale[:, :, None, None]
    fwd = fwd.reshape(64, 64)
    # inverse: S[y,x] = sum_{v,u} scale[v,u] * D[v,u] COS[v,y] COS[u,x]
    # (the same matrix transposed by orthogonality)
    inv = np.einsum("vy,ux->yxvu", cos, cos) * scale[None, None, :, :]
    inv = inv.reshape(64, 64)
    return fwd, inv


_FWD64, _INV64 = _basis64()


def forward_dct(blocks: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """[B, 64] int spatial blocks -> [B, 64] int32 DCT coefficients.

    Truncation toward zero matches the reference's `int(sum * cu*cv / 4)`
    (jpezy_encoder.hpp:163).  float64 uses the reference's exact term and
    accumulation order (summation-order ties flip ~2% of blocks by +-1;
    see codec/oracle.py); float32 uses the matmul form.
    """
    if dtype == jnp.float64:
        return _forward_dct_ordered(blocks)
    m = jnp.asarray(_FWD64, dtype=dtype)
    d = jnp.dot(blocks.astype(dtype), m.T, preferred_element_type=dtype,
                precision=jax.lax.Precision.HIGHEST)
    return d.astype(jnp.int32)


def rounded(x):
    """x as a value XLA must round on its own: the select between its
    producing multiply and any later add keeps the compiler from
    contracting the two into one FMA, and from folding a chain of constant
    multiplies into one.  The float64 DCT/IDCT pass every product through
    it, so they round like the oracle's numpy, one operation at a time.
    (x == x holds for every finite x.)"""
    return jnp.where(x == x, x, jnp.zeros_like(x))


def _forward_dct_ordered(blocks: jnp.ndarray) -> jnp.ndarray:
    from ..codec import oracle as _o

    pic = blocks.astype(jnp.float64)
    s = jnp.zeros(pic.shape, jnp.float64)
    c1 = jnp.asarray(_o._FWD_C1)
    c2 = jnp.asarray(_o._FWD_C2)
    for k in range(64):
        t = rounded(pic[:, k : k + 1] * c1[k][None, :])
        s = s + rounded(t * c2[k][None, :])
    s = s.reshape(-1, 8, 8)
    cu = jnp.asarray(_o._CU_J)
    res = rounded(rounded(s * cu[None, None, :]) * cu[None, :, None]) / 4.0
    return res.reshape(-1, 64).astype(jnp.int32)


def inverse_dct(coeffs: jnp.ndarray, level_shift: int = 128,
                dtype=jnp.float32) -> jnp.ndarray:
    """[B, 64] dequantized int coefficients -> [B, 64] int32 spatial samples.

    Matches `int(sum/4 + sl)` of jpezy_decoder.hpp:667 (sl = 128 for 8-bit).
    float64 replicates the reference's accumulation order exactly.
    """
    if dtype == jnp.float64:
        return _inverse_dct_ordered(coeffs, level_shift)
    m = jnp.asarray(_INV64, dtype=dtype)
    s = jnp.dot(coeffs.astype(dtype), m.T, preferred_element_type=dtype,
                precision=jax.lax.Precision.HIGHEST)
    return (s + jnp.asarray(level_shift, dtype)).astype(jnp.int32)


def _inverse_dct_ordered(coeffs: jnp.ndarray, level_shift: int) -> jnp.ndarray:
    from ..codec import oracle as _o

    d = coeffs.astype(jnp.float64)
    s = jnp.zeros(d.shape, jnp.float64)
    cucv = jnp.asarray(_o._INV_CUCV)
    c1 = jnp.asarray(_o._INV_C1)
    c2 = jnp.asarray(_o._INV_C2)
    for k in range(64):
        t = rounded(rounded(cucv[k] * d[:, k : k + 1]) * c1[k][None, :])
        s = s + rounded(t * c2[k][None, :])
    return (s / 4.0 + jnp.float64(level_shift)).astype(jnp.int32)
