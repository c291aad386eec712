"""High-level sharded codec entry points.

encode_sharded: image batch + ('data','tile') mesh -> JFIF streams, with the
DC-carry collective across tile shards and ON-DEVICE per-shard stream
concat; the host splices the per-shard bitstrings (byte-granular).

decode_sharded: same-geometry JPEGs -> pixels, host entropy frontend +
ONE fused shard_map over all components with a single device fetch
(the referent is the full decode pipeline, jpezy_decoder.hpp:76-134).

Cards joined all to all (NVLink) take any mesh order.  Across hosts, lay
'data' over the hosts and 'tile' within each; see
jpezy_tpu.parallel.distributed for multi-host init.

All encode extensions (quality, restart_interval, optimize) are supported
here with the same semantics as codec.jax_codec.encode (docs/PARITY.md);
`optimize` derives one optimal Huffman table set for the whole batch.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..bitstream import writer
from ..bitstream.splice import splice_blocks
from ..codec.jax_codec import _assemble_restart_segments
from ..core import tables as T
from ..core.geometry import EncodeGeometry
from ..core.props import make_encode_props
from . import sharded


def decode_sharded(mesh: Mesh, streams: list[bytes], *,
                   gray: bool = False,
                   precision: str = "fast") -> np.ndarray:
    """Decode same-geometry JPEGs with the device stages sharded over the
    mesh (images x MCU-row tiles) -> [N, H, W, 3] uint8.

    The entropy frontend runs on the host (see docs/DESIGN.md section 4);
    coefficient blocks shard over 'tile' (contiguous MCU-row ranges), and
    ONE fused shard_map runs dequant/IDCT/upsample/color for every
    component with no collectives and a single uint8 fetch.
    """
    from ..bitstream.reader import parse
    from ..codec import jax_codec
    from ..core.geometry import ComponentGeometry

    pjs = [parse(s) for s in streams]
    p0 = pjs[0]
    hmax, vmax = p0.hmax, p0.vmax
    geos = [
        ComponentGeometry(fc.H, fc.V, hmax, vmax, p0.props.width,
                          p0.props.height)
        for fc in p0.frame_components
    ]
    mcus_x, mcus_y = geos[0].mcus_x, geos[0].mcus_y
    level = 128 if p0.props.sample_precision == 8 else 2048

    if p0.restart_interval and precision == "fast" and not gray:
        try:
            return _decode_sharded_device(
                mesh, pjs, p0, mcus_x, mcus_y, level)
        except (ImportError, ValueError):
            pass  # ineligible stream/mesh shape: host-frontend path below
    per_image = jax_codec._decode_entropy_batch(pjs)

    ncomp = len(p0.frame_components)
    comps = tuple(
        (fc.V, fc.H, geos[i].dup_y, geos[i].dup_x)
        for i, fc in enumerate(p0.frame_components)
    )
    fn = sharded.make_sharded_decode(
        mesh, comps=comps, mcus_x=mcus_x, level=level,
        gray=gray or ncomp == 1, precision=precision,
    )
    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("data", "tile", None))
    coeffs = [
        jax.device_put(np.stack([pi[c] for pi in per_image]), spec)
        for c in range(ncomp)
    ]
    qtables = [jnp.asarray(p0.quant[fc.Tq]) for fc in p0.frame_components]
    out = np.asarray(fn(*coeffs, *qtables))        # ONE fetch for the batch
    H, W = p0.props.height, p0.props.width
    out = out[:, :H, :W]
    if out.shape[-1] == 1:
        out = np.repeat(out, 3, axis=-1)
    return out


def _decode_sharded_device(mesh: Mesh, pjs, p0, mcus_x, mcus_y, level):
    """Mesh-sharded FULL device decode of restart 4:2:0 streams: every
    shard runs its own Huffman lockstep scan -- zero collectives, zero
    host coefficients (sharded.make_sharded_decode_device).  Raises
    ValueError when the stream or mesh shape is ineligible (caller falls
    back to the host-frontend path)."""
    from ..codec.jax_codec import _device_host_frontend
    from ..ops.entropy_decode import build_scan_tables, device_lut

    std420 = (
        len(p0.frame_components) == 3
        and [(fc.H, fc.V) for fc in p0.frame_components]
        == [(2, 2), (1, 1), (1, 1)]
        and [(sc.Td, sc.Ta) for sc in p0.scan_components]
        == [(0, 0), (1, 1), (1, 1)]
    )
    ri = p0.restart_interval
    nmcu = mcus_x * mcus_y
    N = len(pjs)
    data_ax, tile_ax = mesh.shape["data"], mesh.shape["tile"]
    if not std420:
        raise ValueError("sharded device decode needs standard 4:2:0")
    if nmcu % ri:
        raise ValueError("sharded device decode needs ri | nmcu")
    nseg = nmcu // ri
    n_glob = N * jax.process_count()   # multi-host: pjs are local images
    if n_glob % data_ax or nseg % tile_ax or (nseg // tile_ax * ri) % mcus_x:
        raise ValueError("mesh shape does not divide segments/MCU rows")
    for pj in pjs[1:]:
        if pj.restart_interval != ri:
            raise ValueError("uniform DRI required")
        for cls in (0, 1):
            for tid in (0, 1):
                a, b = p0.huff[cls][tid], pj.huff[cls][tid]
                if (not np.array_equal(a.sizes, b.sizes)
                        or not np.array_equal(a.values, b.values)):
                    raise ValueError("uniform Huffman tables required")

    words, nblk, _rawlen = _device_host_frontend(pjs, nmcu, ri, nseg)
    qtuple = tuple(tuple(int(x) for x in p0.quant[fc.Tq])
                   for fc in p0.frame_components)
    fn = sharded.make_sharded_decode_device(
        mesh, ri=ri, mcus_x=mcus_x, level=level, qtuple=qtuple)
    Lw = words.shape[1]
    if jax.process_count() > 1:
        # multi-host: `streams`/pjs are THIS process's local images; each
        # host feeds its own frontend output (no image bytes cross hosts) and
        # reassembles its own rows from the addressable shards
        from .distributed import (gather_local_rows, make_global_from_local,
                                  replicate_global)
        from jax.sharding import PartitionSpec as P

        words_d = make_global_from_local(
            mesh, words.reshape(N, nseg, Lw), P("data", "tile", None))
        nblk_d = make_global_from_local(
            mesh, nblk.reshape(N, nseg), P("data", "tile"))
        lut_d = replicate_global(mesh, build_scan_tables(p0.huff))
        out = gather_local_rows(fn(words_d, nblk_d, lut_d), N)
        return out[:, :p0.props.height, :p0.props.width]
    spec3 = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("data", "tile", None))
    spec2 = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("data", "tile"))
    words_d = jax.device_put(words.reshape(N, nseg, Lw), spec3)
    nblk_d = jax.device_put(nblk.reshape(N, nseg), spec2)
    out = np.asarray(fn(words_d, nblk_d,
                        device_lut(build_scan_tables(p0.huff))))
    return out[:, :p0.props.height, :p0.props.width]


def encode_sharded(mesh: Mesh, batch_rgb: np.ndarray, *, gray: bool = False,
                   precision: str = "fast", rounded: bool = False,
                   quality: int | None = None, restart_interval: int = 0,
                   optimize: bool = False) -> list[bytes]:
    """Encode [N, H, W, 3] uint8 over the mesh -> list of JFIF streams.

    Constraints: N % data_axis == 0, H % 16 == 0, W % 16 == 0,
    (H/16) % tile_axis == 0; with restart_interval, MCUs-per-shard must be
    a multiple of restart_interval (shard boundaries on segment boundaries).

    quality / restart_interval / optimize: same extensions as
    codec.jax_codec.encode; optimize derives ONE optimal Huffman table set
    shared by the whole batch (near-optimal for homogeneous batches; use
    encode(..., optimize=True) for strictly per-image tables).
    """
    return encode_sharded_finish(encode_sharded_dispatch(
        mesh, batch_rgb, gray=gray, precision=precision, rounded=rounded,
        quality=quality, restart_interval=restart_interval,
        optimize=optimize))


def encode_sharded_dispatch(mesh: Mesh, batch_rgb: np.ndarray, *,
                            gray: bool = False, precision: str = "fast",
                            rounded: bool = False,
                            quality: int | None = None,
                            restart_interval: int = 0,
                            optimize: bool = False):
    """Device half of encode_sharded: shard, run the mesh program, fetch
    the compact per-shard streams.  Returns an opaque ticket for
    encode_sharded_finish (the host splice/assembly half).  The split lets
    callers measure device-side sharding cost separately from the host
    splice, which shards across hosts in a multi-host run (scripts/scaling.py).
    """
    n, h, w = batch_rgb.shape[:3]
    if restart_interval < 0:
        raise ValueError(
            f"restart_interval must be >= 0, got {restart_interval}")
    geo = EncodeGeometry(width=w, height=h)
    tile = mesh.shape["tile"]
    mcus_per_shard = geo.num_mcus // tile
    ri = restart_interval
    if ri and mcus_per_shard % ri:
        raise ValueError(
            f"restart_interval {ri} must divide MCUs per tile shard "
            f"({mcus_per_shard}) so segments align with shard boundaries")

    r = sharded.shard_batch(mesh, np.ascontiguousarray(batch_rgb[..., 0]))
    g = sharded.shard_batch(mesh, np.ascontiguousarray(batch_rgb[..., 1]))
    b = sharded.shard_batch(mesh, np.ascontiguousarray(batch_rgb[..., 2]))

    huff = None
    yq = cbq = crq = yflat = cflat = None
    if optimize:
        qfn = sharded.make_sharded_quantize(
            mesh, gray=gray, precision=precision, rounded=rounded,
            quality=quality, restart_interval=ri,
        )
        yq, cbq, crq, hists = qfn(r, g, b)
        hists = np.asarray(hists)
        ydc_bv, yac_bv, *yflat = T.optimal_flat_tables(hists[0], hists[1])
        cdc_bv, cac_bv, *cflat = T.optimal_flat_tables(hists[2], hists[3])
        huff = (ydc_bv, cdc_bv, yac_bv, cac_bv)

    def _dispatch(maxw_shard: int) -> np.ndarray:
        if optimize:
            efn = sharded.make_sharded_emit_stream(
                mesh, restart_interval=ri, maxw_shard=maxw_shard)
            return np.asarray(efn(
                yq, cbq, crq, tuple(jnp.asarray(a) for a in yflat),
                tuple(jnp.asarray(a) for a in cflat)))
        fn = sharded.make_sharded_encode_stream(
            mesh, gray=gray, precision=precision, rounded=rounded,
            quality=quality, restart_interval=ri, maxw_shard=maxw_shard,
        )
        return np.asarray(fn(r, g, b))

    combined = _dispatch(0)                       # ONE compact fetch
    S_shard = mcus_per_shard // ri if ri else 0
    maxw = combined.shape[2] - 1 - S_shard
    max_total = int(combined[:, :, 0].astype(np.int64).max())
    if max_total > 32 * maxw:
        # dense content blew the default ~2 bit/px budget: re-dispatch with
        # a budget fitted to the observed max (pays one recompile; ADVICE r2
        # asked the overflow not to be fatal)
        need = -(-max_total // 32)
        need += (-need) % 128                     # lane-aligned
        combined = _dispatch(need)
        maxw = combined.shape[2] - 1 - S_shard
    return (combined, n, w, h, gray, quality, ri, huff, S_shard, maxw)


def encode_sharded_finish(ticket) -> list[bytes]:
    """Host half of encode_sharded: splice per-shard streams + headers."""
    combined, n, w, h, gray, quality, ri, huff, S_shard, maxw = ticket
    ntile = combined.shape[1]

    qt = T.scale_quant_tables(quality) if quality is not None else None
    header = writer.write_header(make_encode_props(w, h, gray=gray),
                                 restart_interval=ri, quant_tables=qt,
                                 huff_tables=huff)
    out = []
    for i in range(n):
        if ri:
            # per-shard streams hold whole byte-aligned segments; chain
            # them with globally cycling RSTn indices
            seg_bits = np.concatenate(
                [combined[i, t, 1 : 1 + S_shard] for t in range(ntile)])
            raws = []
            for t in range(ntile):
                total = int(combined[i, t, 0])
                stream = combined[i, t, 1 + S_shard :]
                if total > 32 * maxw:
                    raise OverflowError(
                        "per-shard stream budget overflow; raise maxw_shard")
                raws.append(stream.astype(">u4").tobytes()[: (total + 7) // 8])
            out.append(header
                       + _assemble_restart_segments(b"".join(raws), seg_bits)
                       + writer.EOI)
            continue
        totals = combined[i, :, 0].astype(np.int64)
        if np.any(totals > 32 * maxw):
            raise OverflowError(
                "per-shard stream budget overflow; raise maxw_shard")
        # bit-granular splice of the tile shard streams (host, C++-backed)
        packed, _ = splice_blocks(
            np.ascontiguousarray(combined[i, :, 1 + S_shard :]), totals)
        out.append(writer.assemble(header, packed))
    return out
