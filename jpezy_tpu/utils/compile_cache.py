"""Persistent XLA compilation cache placement.

A cache hit skips the XLA compile of a program this checkout has already
compiled with the same shapes.  Call enable() before the first jit
execution.  Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and
nothing is set here; otherwise the cache lives at the fixed
<repo>/.xla_cache (listed in .gitignore).  The path is part of what makes
the cache hit, so it never moves.
"""
from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".xla_cache")


def enable() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
