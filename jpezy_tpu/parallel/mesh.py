"""Device mesh helpers.

The canonical mesh is 2-axis ('data', 'tile'):
  - 'data': independent images (pure data parallelism, no collectives)
  - 'tile': MCU-row ranges of a single image (needs a DC-predictor carry
    exchange between neighboring shards on encode; cf. SURVEY.md section 2.7)

Cards joined all to all (NVLink within a host) reach each other at one
rate, so the mesh order follows the algorithm alone.  Across hosts, lay
'data' over the hosts and 'tile' within each, so the carry ppermute never
leaves a host.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(data: int = 1, tile: int | None = None,
              devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if tile is None:
        tile = n // data
    if data * tile > n:
        raise ValueError(f"mesh {data}x{tile} needs more than {n} devices")
    devices = devices[: data * tile]
    dev_array = np.asarray(devices).reshape(data, tile)
    return Mesh(dev_array, axis_names=("data", "tile"))
