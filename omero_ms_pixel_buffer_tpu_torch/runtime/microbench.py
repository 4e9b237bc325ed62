"""Kernel-only device microbenchmarks (counterpart of
``omero_ms_pixel_buffer_tpu/runtime/microbench.py``, same functions and
the same keys).

The compute side of the device engine by itself: the filter kernel
(``ops/kernels/filter.py``) against the plain PyTorch filter, the device
deflate with the default packer (on CUDA the SP kernel,
``csrc/bitpack.cu``), the PyTorch ``scan`` and ``gather`` packers alone,
one host-staged fused batch split into its H2D, compute and D2H stages,
the resident-plane chain (crop from a plane held by
``models/device_cache.py``, filter, deflate) and the device streams'
sizes against host zlib level 6 on the same payloads. Inputs are on the
device before any timing; each timed call ends in
``torch.cuda.synchronize`` on CUDA; the first call of each shape is an
untimed warm-up; a time is the median of the calls (``_time_steady``).

    python -m omero_ms_pixel_buffer_tpu_torch.runtime.microbench \\
        [--batch 32] [--tile 512] [--plane 4096] [--device cuda|cpu]

prints the dict as one JSON line. ``project_throughput`` folds a link
rate into tiles/s: ``1 / (batch_ms/batch + bytes_per_tile/link)``.
``BENCH_PACK_COMPARE=0`` skips the slow gather packer.
"""

from __future__ import annotations

import os
import time
import zlib
from typing import Optional

import numpy as np
import torch

# PNG chunk framing the host adds around a device-built zlib stream
# (8 signature + IHDR 25 + IDAT 12 + IEND 12): the bytes a tile carries
# on the wire beyond the stream itself
_PNG_FRAME_BYTES = 57


def synth_tiles(
    b: int, h: int, w: int, dtype=np.uint16, seed: int = 5,
    noise: float = 120.0,
) -> np.ndarray:
    """Microscopy-like content (a smooth field and sensor noise), so the
    compressed sizes are realistic rather than white noise's."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 2000 + 1500 * np.sin(xx / 97.0) + 1500 * np.cos(yy / 131.0)
    info = np.iinfo(dtype)
    tiles = (base[None] + rng.normal(0, noise, (b, h, w))).clip(info.min, info.max)
    return tiles.astype(dtype)


def synth_rgb_tiles(b: int, h: int, w: int, seed: int = 5, noise: float = 6.0) -> np.ndarray:
    """Rendered-RGB-like content (three smooth composited channels and
    light noise): the fixture of the ``dynamic`` ratio, where runs are
    rarer than in raw grey planes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = []
    for ph, (fx, fy) in enumerate(((97.0, 131.0), (61.0, 89.0), (151.0, 47.0))):
        chans.append(120 + 60 * np.sin(xx / fx + ph) + 50 * np.cos(yy / fy))
    img = np.stack(chans, -1)[None] + rng.normal(0, noise, (b, h, w, 3))
    return img.clip(0, 255).astype(np.uint8)


def _synchronizer(device: torch.device):
    """A call that waits for ``device``'s work (nothing on the CPU)."""
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _time_steady(fn, iters: int, sync) -> float:
    """Seconds per call at steady state: one untimed warm call, then the
    median of ``iters`` calls, each ended by ``sync``."""
    fn()
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _sig(value: float, digits: int = 3) -> float:
    """Round to significant figures, so a small positive rate never
    rounds to 0.0."""
    if value == 0:
        return 0.0
    return float(f"{value:.{digits}g}")


def run_microbench(
    batch: int = 32,
    tile: int = 512,
    plane: int = 4096,
    iters_filter: int = 20,
    iters_deflate: int = 5,
    seed: int = 5,
    device="cuda",
) -> dict:
    """Every kernel-only metric as one dict, on ``device`` (default the
    card; raises without one; ``"cpu"`` runs the kernels' plain
    versions, for the tests)."""
    from ..models.device_cache import DevicePlaneCache
    from ..ops.convert import bits_tensor, to_big_endian_bytes
    from ..ops.device_deflate import (
        _lane_tokens,
        _pack_bits_gather,
        _packing_maxbits,
        deflate_filtered_batch,
        fused_filter_deflate_batch,
        fused_filter_deflate_dynamic,
    )
    from ..ops.kernels.bitpack import pack_bits_scan
    from ..ops.kernels.bitpack_dense import emit_ops_per_token
    from ..ops.kernels.filter import filter_tiles
    from ..ops.png import filter_batch
    from .device import resolve_device

    dev = resolve_device(device)
    sync = _synchronizer(dev)
    out: dict = {"batch": batch, "tile": tile, "backend": dev.type}
    tiles_np = synth_tiles(batch, tile, tile, seed=seed)
    itemsize = tiles_np.dtype.itemsize
    in_bytes = tiles_np.nbytes
    tiles = bits_tensor(tiles_np).to(dev)
    sync()

    # (a) fused byteswap + PNG filter: the kernel, then the plain version
    dt = _time_steady(lambda: filter_tiles(tiles, "up"), iters_filter, sync)
    out["filter_gbps"] = _sig(in_bytes / dt / 1e9)
    out["filter_ms_per_batch"] = round(dt * 1e3, 3)
    filtered = filter_tiles(tiles, "up")

    def plain_filter():
        rows = to_big_endian_bytes(tiles).reshape(batch, tile, -1)
        return filter_batch(rows, itemsize, "up")

    dt = _time_steady(plain_filter, iters_filter, sync)
    out["filter_gbps_xla"] = _sig(in_bytes / dt / 1e9)

    # (b) device deflate (rle: the Z_RLE decomposition, fixed Huffman)
    # with the default packer
    row_bytes = 1 + tile * itemsize
    payload_bytes = batch * tile * row_bytes
    dt = _time_steady(lambda: deflate_filtered_batch(filtered, tile, row_bytes),
                      iters_deflate, sync)
    out["deflate_gbps"] = _sig(payload_bytes / dt / 1e9)
    out["deflate_ms_per_batch"] = round(dt * 1e3, 2)

    # (b2) the PyTorch packers alone, on tokens built outside the timing
    payloads = filtered[:, :tile, :row_bytes].reshape(batch, -1)
    tok_bits, tok_nbits = _lane_tokens(payloads)
    maxbits = _packing_maxbits(payloads.shape[1])
    sync()
    dt = _time_steady(lambda: pack_bits_scan(tok_bits, tok_nbits, maxbits), iters_deflate, sync)
    out["pack_gbps"] = _sig(payload_bytes / dt / 1e9)
    if os.environ.get("BENCH_PACK_COMPARE", "1") != "0":
        dt_g = _time_steady(lambda: _pack_bits_gather(tok_bits, tok_nbits, maxbits),
                            max(2, iters_deflate // 2), sync)
        out["pack_gbps_gather"] = _sig(payload_bytes / dt_g / 1e9)
        out["pack_speedup_vs_gather"] = _sig(dt_g / dt)

    # (b2b) the TPU emit formulations' op counts: constants, not a timing
    dense_ops, sp_ops = emit_ops_per_token("dense"), emit_ops_per_token("sp")
    out["emit_ops_per_token"] = {"dense": round(dense_ops, 1), "sp": round(sp_ops, 1),
                                 "reduction_x": _sig(dense_ops / sp_ops)}

    # (b3) one host-staged fused batch by stage: H2D of the tiles, the
    # filter + rle chain, the pull of the lengths and the streams (cut to
    # a serving-like power-of-two cap)
    warm_s, warm_l = fused_filter_deflate_batch(
        bits_tensor(tiles_np).to(dev), tile, row_bytes, itemsize)
    cap = min(warm_s.shape[1],
              1 << max(int(warm_l.max().item()) - 1, 63).bit_length())
    stages: dict = {"h2d": [], "compute": [], "d2h": []}
    for _ in range(iters_deflate):
        t0 = time.perf_counter()
        staged = bits_tensor(tiles_np).to(dev)
        sync()
        t1 = time.perf_counter()
        s, length = fused_filter_deflate_batch(staged, tile, row_bytes, itemsize)
        sync()
        t2 = time.perf_counter()
        length.cpu()
        s[:, :cap].cpu()
        t3 = time.perf_counter()
        stages["h2d"].append(t1 - t0)
        stages["compute"].append(t2 - t1)
        stages["d2h"].append(t3 - t2)
    out["stage_breakdown"] = {f"{k}_ms": round(sorted(v)[len(v) // 2] * 1e3, 3)
                              for k, v in stages.items()}
    out["stage_breakdown"]["pack_gbps"] = out["pack_gbps"]

    # (c) the chain from a resident plane: crop, filter, deflate, with
    # nothing crossing to the host inside the timed call
    plane_dev = bits_tensor(synth_tiles(1, plane, plane, seed=seed + 1)[0]).to(dev)
    rng = np.random.default_rng(seed + 2)
    span = (plane - tile) // 64 + 1
    ys = (rng.integers(0, span, batch) * 64).tolist()
    xs = (rng.integers(0, span, batch) * 64).tolist()
    coords = list(zip(ys, xs))
    sync()

    def chain():
        crops = DevicePlaneCache.crop_batch(plane_dev, coords, tile, tile)
        return deflate_filtered_batch(filter_tiles(crops, "up"), tile, row_bytes)

    dt = _time_steady(chain, iters_deflate, sync)
    out["batch_ms_steady"] = round(dt * 1e3, 2)
    out["chain_tiles_per_sec_compute"] = round(batch / dt, 1)

    # the streams' sizes against host zlib level 6 on the same payloads
    _, lengths = deflate_filtered_batch(filtered, tile, row_bytes)
    dev_sizes = lengths.cpu().numpy().astype(np.int64)
    filtered_np = filtered.cpu().numpy()
    host_sizes = np.array([len(zlib.compress(filtered_np[i, :tile, :row_bytes].tobytes(), 6))
                           for i in range(batch)], dtype=np.int64)
    out["device_bytes_per_tile"] = round(float(dev_sizes.mean()), 1)
    out["host_bytes_per_tile"] = round(float(host_sizes.mean()), 1)
    out["deflate_ratio_vs_host"] = round(float(dev_sizes.mean() / host_sizes.mean()), 3)
    out["deflate_compression_x"] = round(float(tile * row_bytes / dev_sizes.mean()), 2)

    # dynamic Huffman on the rendered-RGB fixture, and rle on the same
    # payloads, against host zlib level 6
    rgb_np = synth_rgb_tiles(batch, tile, tile, seed=seed)
    rgb_rows = 1 + tile * 3
    rgb_dev = torch.from_numpy(rgb_np).to(dev)
    sync()
    _, lengths_d = fused_filter_deflate_dynamic(rgb_dev, tile, rgb_rows, 3)
    dyn_sizes = lengths_d.cpu().numpy().astype(np.int64)
    rgb_filtered = filter_batch(rgb_dev.reshape(batch, tile, tile * 3), 3, "up").cpu().numpy()
    rgb_host = np.array([len(zlib.compress(rgb_filtered[i].tobytes(), 6))
                         for i in range(batch)], dtype=np.int64)
    out["deflate_ratio_vs_host_dynamic"] = round(float(dyn_sizes.mean() / rgb_host.mean()), 3)
    _, lengths_r = fused_filter_deflate_batch(rgb_dev, tile, rgb_rows, 3, mode="rle")
    out["deflate_ratio_vs_host_rle_rgb"] = round(
        float(lengths_r.cpu().numpy().astype(np.int64).mean() / rgb_host.mean()), 3)
    dt = _time_steady(lambda: fused_filter_deflate_dynamic(rgb_dev, tile, rgb_rows, 3),
                      max(2, iters_deflate // 2), sync)
    out["deflate_dynamic_gbps"] = _sig(batch * tile * rgb_rows / dt / 1e9)
    return out


def project_throughput(micro: dict, link_mbps: Optional[float],
                       colocated_gbps: float = 8.0) -> dict:
    """Measured compute folded into a compute-plus-link model: per
    coalesced batch only the streams cross the link (the plane is
    resident), so ``tiles/s = 1 / (batch_s/batch + bytes_per_tile /
    link_Bps)``, for the given link (``link_mbps``, MB/s) and an assumed
    co-located link of ``colocated_gbps`` GB/s."""
    need = ("batch_ms_steady", "batch", "device_bytes_per_tile")
    if any(k not in micro for k in need):
        return {}
    compute_s_per_tile = micro["batch_ms_steady"] / 1e3 / micro["batch"]
    wire_bytes = micro["device_bytes_per_tile"] + _PNG_FRAME_BYTES
    out = {
        "projected_colocated_tiles_per_sec": round(
            1.0 / (compute_s_per_tile + wire_bytes / (colocated_gbps * 1e9)), 1),
        "projection_model": ("1/(batch_ms/batch + bytes_per_tile/link);"
                             f" colocated link {colocated_gbps:g} GB/s"),
    }
    if link_mbps:
        out["projected_tunnel_tiles_per_sec"] = round(
            1.0 / (compute_s_per_tile + wire_bytes / (link_mbps * 1e6)), 1)
    return out


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description="Kernel-only device microbenchmarks")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--tile", type=int, default=512)
    p.add_argument("--plane", type=int, default=4096)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    print(json.dumps(run_microbench(args.batch, args.tile, args.plane, device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
