"""Profiling helpers: reference-style section timing + jax.profiler traces
and a roofline estimate for the codec's device stages.

(SURVEY.md section 5: the reference only has RAII wall-clock messengers;
the device equivalents are program-level traces and FLOP/byte accounting.)
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import time


@contextlib.contextmanager
def device_trace(logdir: str):
    """jax.profiler trace context (view with tensorboard/xprof)."""
    import jax

    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def card_lines() -> list[str]:
    """Each GPU's name and power limit as nvidia-smi reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"), read by a child process that does
    not touch JAX.  A card below its maximum power limit runs slower under
    load, so every reported time names the limit beside the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def encode_flops(width: int, height: int) -> dict:
    """Static cost model for one image encode (fast path)."""
    mcus = -(-height // 16) * -(-width // 16)
    blocks = mcus * 6
    return {
        "dct_flops": blocks * 64 * 64 * 2,          # [B,64]@[64,64]
        "color_flops": width * height * 3 * 5,       # 3 planes x ~5 madds
        "entropy_vpu_ops": blocks * 64 * 40,         # emissions + pack
        "hbm_bytes": width * height * 3 + blocks * 64 * 4 * 3,
        "blocks": blocks,
    }


class Stopwatch:
    """Accumulating named stopwatch for pipeline stage attribution."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        width = max((len(k) for k in self.totals), default=0)
        return "\n".join(
            f"{k.ljust(width)}  {v * 1000:8.2f} ms"
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        )
