"""jpezy_tpu: a batched baseline JPEG codec framework for accelerators.

Capabilities match the reference jpezy (PPM P3 in -> JFIF 4:2:0 baseline out,
JPEG in -> PPM out, fixed ISO/IEC 10918-1 Annex K tables) re-designed as a
batched, mesh-shardable array program on JAX/XLA with a C++ host
runtime for byte-granular I/O.

Public API (the reference's library embedding analog, README.md:158-175):

    from jpezy_tpu import encode, decode, encode_batch, decode_batch
    jpeg_bytes = encode(r, g, b)                  # planes [H, W] uint8
    r, g, b, props = decode(jpeg_bytes)

encode_host/decode_host run the complete host C++ codec (small one-shot
images; byte-identical).  See jpezy_tpu.codec.jax_codec for
precision/rounded/restart/transport options,
jpezy_tpu.parallel for the mesh-sharded pipelines, and jpezy_tpu.cli for the
command-line front-end.
"""
from __future__ import annotations

__version__ = "0.1.0"


def encode(*args, **kwargs):
    from .codec.jax_codec import encode as _encode

    return _encode(*args, **kwargs)


def decode(*args, **kwargs):
    from .codec.jax_codec import decode as _decode

    return _decode(*args, **kwargs)


def encode_batch(*args, **kwargs):
    from .codec.jax_codec import encode_batch as _f

    return _f(*args, **kwargs)


def decode_batch(*args, **kwargs):
    from .codec.jax_codec import decode_batch as _f

    return _f(*args, **kwargs)


def encode_mixed(*args, **kwargs):
    from .runtime.batch import encode_mixed as _f

    return _f(*args, **kwargs)


def encode_host(*args, **kwargs):
    """Complete host C++ codec path (no accelerator, no XLA): byte-identical
    streams, ~25 ms for a 512x512 round trip.  The CLI auto-picks this
    below 8 MP; see codec/host_codec.py."""
    from .codec.host_codec import encode as _f

    return _f(*args, **kwargs)


def decode_host(*args, **kwargs):
    from .codec.host_codec import decode as _f

    return _f(*args, **kwargs)
