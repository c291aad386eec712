"""Multi-host initialization and host-sharded batch placement.

In a multi-host run, each host process calls initialize() once, builds the
global ('data', 'tile') mesh over all devices, and feeds its local image
shard with make_global_batch().  The DC-carry ppermute runs between the
cards of one host (all to all over NVLink); the 'data' axis carries no
collectives, so no traffic crosses hosts during encode.

This module is exercised in CI only up to mesh construction (single
process); the multi-host path follows the standard jax.distributed contract.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize with env-var fallbacks (no-op if single)."""
    if num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_global_mesh(data: int | None = None, tile: int | None = None) -> Mesh:
    """Global mesh over all devices of all processes.

    Default: 'data' spans hosts (process-major device order), 'tile' spans
    the devices within a host, so the carry ppermute stays within a host.
    """
    devices = np.asarray(jax.devices())
    n = len(devices)
    if data is None:
        data = max(1, jax.process_count())
    if tile is None:
        tile = n // data
    return Mesh(devices[: data * tile].reshape(data, tile), ("data", "tile"))


def make_global_batch(mesh: Mesh, local_batch: np.ndarray) -> jax.Array:
    """Assemble a process-local [N_loc, H, W] shard into the global array.

    Uses jax.make_array_from_process_local_data so no image bytes cross hosts.
    """
    return make_global_from_local(
        mesh, local_batch, P("data", "tile", None))


def make_global_from_local(mesh: Mesh, local: np.ndarray,
                           spec: P) -> jax.Array:
    """Place a process-local leading-axis shard into a global array whose
    leading axis spans processes ('data' = hosts); single-process falls
    back to a plain device_put.  No bytes cross hosts."""
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(local, sharding)
    global_shape = (local.shape[0] * jax.process_count(), *local.shape[1:])
    return jax.make_array_from_process_local_data(
        sharding, local, global_shape)


def replicate_global(mesh: Mesh, arr: np.ndarray) -> jax.Array:
    """Replicate a host array (same value on every process) across the
    whole mesh -- e.g. the decode LUT.  make_array_from_callback avoids
    any cross-process value transfer."""
    sharding = NamedSharding(mesh, P(*([None] * arr.ndim)))
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx])


def gather_local_rows(out: jax.Array, n_local: int) -> np.ndarray:
    """Reassemble THIS process's data-axis rows of a ('data', 'tile', ...)
    sharded result from its addressable shards -> [n_local, ...] numpy.

    The inverse of make_global_from_local for the decode output: with
    'data' spanning hosts and 'tile' within a host, every tile shard of a
    local image is addressable, so no traffic crosses hosts."""
    if jax.process_count() == 1:
        return np.asarray(out)[:n_local] if n_local else np.asarray(out)
    rows: dict[int, dict[int, np.ndarray]] = {}
    for s in out.addressable_shards:
        r0 = s.index[0].start or 0
        t0 = s.index[1].start or 0
        rows.setdefault(r0, {})[t0] = np.asarray(s.data)
    parts = []
    for r0 in sorted(rows):
        tiles = [rows[r0][t] for t in sorted(rows[r0])]
        parts.append(np.concatenate(tiles, axis=1))
    local = np.concatenate(parts, axis=0)
    assert local.shape[0] == n_local, (local.shape, n_local)
    return local
