"""Deterministic synthetic test images (no jax imports, no config side
effects -- safe to import from benchmarks and chip_smoke.py)."""
import numpy as np


def make_test_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Natural-ish synthetic image: smooth gradients + texture + edges."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack(
        [
            128 + 90 * np.sin(2 * np.pi * xx / max(w, 1) * 2.3) * np.cos(2 * np.pi * yy / max(h, 1)),
            128 + 70 * np.cos(2 * np.pi * (xx + yy) / max(w + h, 1) * 3.1),
            128 + 80 * np.sin(2 * np.pi * yy / max(h, 1) * 1.7),
        ],
        axis=-1,
    )
    texture = rng.normal(0, 12, size=(h, w, 3))
    # hard edges (blocks of flat color) to exercise long zero runs / EOB
    base[h // 4 : h // 2, w // 4 : w // 2] = [200, 30, 60]
    base[: h // 8, :] = 255
    base[-h // 8 :, :] = 0
    img = np.clip(base + texture, 0, 255)
    return img.astype(np.uint8)
