"""A/B the pack_block_words implementations (reduce / fori / prefix) inside
the fused batch encode, for bit-equality and steady-state device time.

Usage: python scripts/packbench.py [N]   (default 16 images of 512x512)

Each method runs in a fresh jit of the fused ycc420 batch encode
(JPEZY_PACK is read at trace time), standard and DRI=8, with the methods
timed in turns.  Times are medians of block_until_ready-bracketed calls;
every line names the device.
"""
from __future__ import annotations

import functools
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

METHODS = ("reduce", "fori", "prefix")


def main():
    import jax
    import jax.numpy as jnp

    from imagegen import make_test_image
    from jpezy_tpu.codec import jax_codec

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    h = w = 512
    dev = jax.devices()[0]
    label = f"{dev.platform}, {dev.device_kind}"
    imgs = np.stack([make_test_image(h, w, seed=i) for i in range(n)])
    y, cb, cr = jax_codec.host_rgb_to_ycc420(imgs)
    packed = jnp.asarray(np.concatenate(
        [y.reshape(n, -1), cb.reshape(n, -1), cr.reshape(n, -1)], axis=1))

    fns, outs = {}, {}
    for m in METHODS:
        os.environ["JPEZY_PACK"] = m
        for ri in (0, 8):
            fn = jax.jit(functools.partial(
                jax_codec._encode_batch_blocks_packed.__wrapped__,
                h=h, w=w, restart_interval=ri))
            outs[m, ri] = np.asarray(fn(packed)[0])     # compile + result
            fns[m, ri] = fn
    os.environ.pop("JPEZY_PACK", None)

    times = {k: [] for k in fns}
    for rep in range(2):                                # turns: a b c c b a
        for m in (METHODS if rep == 0 else METHODS[::-1]):
            for ri in (0, 8):
                fn = fns[m, ri]
                ts = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    jax.block_until_ready(fn(packed))
                    ts.append(time.perf_counter() - t0)
                times[m, ri].append(float(np.median(ts)))
    for (m, ri), ts in sorted(times.items()):
        eq = np.array_equal(outs[m, ri], outs["reduce", ri])
        print(f"pack[{m:6s}] DRI={ri} fused encode {n}x{h}x{w}: "
              f"{', '.join(f'{t * 1e3:.3f}' for t in ts)} ms per turn "
              f"[{label}]  equal to reduce: {eq}", flush=True)


if __name__ == "__main__":
    main()
