#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 42] [--size 8192] [--requests 256] \
        [--rle-requests 128] [--stored-requests 32] [--render-size 4096] \
        [--render-requests 128] [--histogram-requests 128] [--viewports 16] \
        [--wsi-size 16384] [--wsi-requests 512] [--filter-sweep] \
        [--bitpack-sweep] [--bitpack-time | --dense-time [--port-root DIR]]

Phases, one JSON line each on stdout:

1. ``build``   — the three CUDA kernels built from
   ``omero_ms_pixel_buffer_tpu_torch/csrc`` with nvcc (one process per
   source, in parallel).
2. ``fixture`` — an ``--size``² uint16 OME-TIFF with 512x512 zlib tiles:
   a smooth field plus Gaussian noise, made from ``--seed`` (image 1); and
   a ``--render-size``² uint16 OME-TIFF of C = 3, Z = 4, T = 1 with
   512x512 zlib tiles, three distinct smooth fields plus noise (image 2,
   a small fluorescence stack). ``fixture_wsi``: a ``--wsi-size``² RGB8
   whole-slide pyramid from ``--seed`` (image 3: 256x256 JPEG tiles at
   quality 85 and 4:2:0, SubIFD levels down to <= 1024, no OME-XML, so
   ``/tile`` gives RGB lanes), and the layout fixtures: LZW (512²),
   PackBits, zstd (written with raw zstd blocks where the ``zstandard``
   package is missing), zlib with predictor 2, one strip per plane, a
   little-endian BigTIFF, a float32 C = 3 image (1024² each) and a ROMIO
   plane file of C = 2.
3. ``kernels`` — each kernel against its plain PyTorch version on the card
   at the main path's shapes (32 lanes of 512x512 uint16): the filter in
   all five modes plus uint8, RGB uint8 and RGB16 (bpp 6, 256x256
   lanes), and in every mode at the
   geometries of ``FILTER_EDGES`` and on a misaligned input; its
   ``cold_ms`` is its device time with the L2 flushed before each launch.
   The scalar-prefetch packer on the real ``dynamic`` pass-2 tokens of
   those lanes, the dense packer on their real ``rle`` tokens (also
   against the scalar-prefetch packer), and both at the edge geometries of
   ``ops/kernels/bitpack_edges.py`` (``SP_EDGES``, made from ``--seed``,
   as the tests make them) and on one lane of 103 M 21-bit tokens (past
   2^31 bits). Byte equality is required, and every lane's stream must
   inflate back. A kernel's ``ms`` is its device time from torch.profiler
   (CUDA events around the wrapper when the profiler records none): the
   filter's of its kernel, each packer's per call over every kernel and
   memset the call issues; wrapper (``call_ms``) and plain times are CUDA
   events. Then the render shape (``kernels_render``): 32 composites of
   512x512 from image 2 (the ``path_render`` spec), the filter on the
   (32, 512, 512, 3) uint8 RGB and the scalar-prefetch packer on the real
   ``rle`` tokens of those scanlines, each byte-equal to its plain version
   (every lane's stream inflates back), with the composite's device time
   beside its byte bound.
4. ``http_contract`` — the service on the card: a lone 512x512 request
   answered with the host bytes of the single-request path, two 1100x300
   lanes (larger than every bucket) coalesced into one batch and answered
   with the host engine's bytes (``host_engine``: the native engine or
   Python zlib, named on ``/healthz``), ``ETag``/``Cache-Control``/
   ``X-Cache`` on a miss and a hit, 304 on a matching ``If-None-Match``
   (strong, ``W/``, in a list) and 200 on ``*``, HEAD, OPTIONS and an
   unrouted GET's 405.
5. ``path``    — the service (``http.server.create_server``, what
   ``python -m omero_ms_pixel_buffer_tpu_torch`` runs) on 127.0.0.1 in
   this process, deflate mode ``dynamic``, packer ``pallas``; kernel
   launch counters reset to 0 just before; two warm-up rounds of 32
   tiles (the plane is admitted on its second touch), then ``--requests``
   512x512 PNG tiles at concurrency 32 over keep-alive connections, then
   odd sizes and edge cases. Every PNG is inflated with zlib, unfiltered
   with numpy and compared with the source pixels; the filter and the
   scalar-prefetch packer must have launched and the dense packer not,
   the plane cache must have hits and no encode group may have failed.
6. ``path_rle`` — a second server in the same way, deflate mode ``rle``,
   packer ``pallas_dense``: warm-up, ``--rle-requests`` timed tiles,
   edge cases; the filter and the dense packer must have launched and
   the scalar-prefetch packer not. It reports the mean zlib stream bytes
   per 512x512 tile beside the ``dynamic`` phase's.
7. ``path_rle_sp`` — the same with packer ``pallas`` (the scalar-prefetch
   packer must have launched and the dense one not), so that against
   ``path`` only the mode differs.
8. ``path_stored`` — a fourth server, deflate mode ``stored``:
   ``--stored-requests`` tiles, pixel-checked; the filter must have
   launched and neither packer.
9. ``path_render`` — a server with the defaults; counters reset, two
   warm-up rounds of 32, then ``--render-requests`` 512x512 ``/render``
   requests of image 2 at concurrency 32 (three channels, windows and
   colours), then two rounds of 32 each of ``p=intmax|0:3`` (the second
   must stay on the device: ``projection_host_pulls`` unchanged),
   ``p=intmean``, ``m=g``, a ``roi=`` rect and ``maps=`` reverse and
   logarithmic, then the edge cases (a grammar 400, an unknown LUT's 400,
   an out-of-range channel's 404, a projection over the tile budget's
   413, JPEG: 200 with Pillow, 404 without). Every PNG is checked pixel by
   pixel against a numpy composite of the source (the port's
   ``build_tables``, numpy gathers); the filter and the scalar-prefetch
   packer must have launched and no encode group failed. Reports the
   composite's device ms per render group.
10. ``path_host_deflate`` — a server with ``device_deflate=False``: 32
   ``/tile`` PNG requests, pixel-checked; the filter must have launched
   and neither packer (the host deflates: ``host_engine``).
11. ``path_histogram`` — a server with the defaults: ``--histogram-requests``
   ``/histogram`` requests of image 2 (512x512 regions of channels 1-3,
   bins 256 and 65536 in turn, ``usePixelsTypeRange=1``) plus 8 full-plane
   ones (w = h = 0), all timed at concurrency 32. Every body's counts are
   checked against ``np.bincount`` of the source region; every channel
   plane must have been reduced by the torch histogram on the card
   (``/healthz`` ``analysis``), and its device ms per group is reported
   beside its byte bound.
12. ``path_supertile`` — a server with the defaults (super-tile fusion on),
   and ``path_supertile_off``, one with ``supertile_enabled=False``, each
   run twice on a fresh server in the order off, on, on, off (so neither
   always runs first):
   ``--viewports`` pans, each a 4x4 grid of adjacent 512x512
   three-channel ``/render`` PNG tiles (a 2048x2048 viewport, the
   default 4 Mpx budget) at a seeded random origin on the 512 grid, the
   last one at the image's edge (its last column and row 256 wide), each
   viewport with its own windows (no result-cache hit between them); the
   16 requests of a viewport go at once. Every tile is checked against
   the numpy composite; fused device lanes must be > 0 and the filter
   and the scalar-prefetch packer must have launched. Reports the
   super-tile groups, their encode groups, fused lanes (device, host),
   fallback lanes, mean lanes per group and the composite + carve's
   device ms per group beside its byte bound; the off runs must stamp
   nothing. ``supertile_pair`` then gives both settings' tiles/s side by
   side.
13. ``idct`` — ``idct_blocks_torch`` on the card against its CPU version
   and a float64 numpy IDCT (at most 1 count from each) on every block of
   ten JPEG tiles of image 3, equal with TF32 allowed and not; its
   device time at N = 1024 blocks beside the byte bound. The WSI kernel
   rows (``filter_wsi_rgb8``, ``bitpack_wsi``: 32 host-decoded RGB8 lanes
   of 256x256 and their ``dynamic`` pass-2 tokens) are checked and timed
   first.
14. ``path_wsi`` — a server with the defaults: 32 warm-up tiles, then
   ``--wsi-requests`` 256x256 PNG tiles of a DeepZoom-style raster sweep
   over levels 0 and 1 at concurrency 32. Every body is decoded (colour
   type 2) and must equal the port's host decode of the region; the
   filter and the SP packer must have launched, RGB device lanes be > 0
   and no encode group fail. Reports tiles/s, p50/p99, ``timed_window``
   and ``reads`` (the batched host reads' milliseconds and their share
   of ``handle_batch`` time).
15. ``path_wsi_device_idct`` — the same with ``OMPB_JPEG_DEVICE_IDCT=1``
   and a quarter of the tiles: device IDCT calls > 0 on ``/healthz``
   ``jpeg``, every pixel within 3 of the host decode (the count that
   differ is reported), the IDCT's span per call on its stream.
16. ``path_layouts`` — ``/tile`` PNG, raw and TIF of every layout fixture
   and of ROMIO, each against its source; ``/render`` and ``/histogram``
   of the float image against the port's quantization and tables in
   numpy; a float render without windows and a float PNG tile answer 404;
   the zstd image answers 404 without ``zstandard``.

Each path phase also reports ``timed_window``: the encode queue's groups,
stage means and thread busy shares over its timed requests alone (two
``/healthz`` views, just before and just after them), and how many of
those requests bypassed the device: result-cache hits, lone lanes (a
batch of one, encoded on the host), host-encoded oversize lanes and
(``path_render``) render lanes on the host mirror; and the super-tile
counts (``supertile``: lanes stamped, groups, fused device and host
lanes, fallback lanes, crops pulled to the host).

Then the kernels' JSON line (seven rows; the WSI rows' launches from
``path_wsi``), the ``nvidia-smi --query-gpu=name,power.limit``
line, and last ``{"ok": true, "device": {...}}``. ``--filter-sweep`` stops
after the fixture and prints instead the filter kernel's device times over
rows per warp and by mode (``filter_sweep``), and the nvidia-smi line;
``--bitpack-time`` likewise prints the scalar-prefetch packer's device time
per call, call time and kernels by name on the real pass-2 tokens
(``bitpack_time``), ``--dense-time`` the dense packer's on the real ``rle``
tokens (``dense_time``), with ``--port-root`` taking the port package from
another checkout (an earlier version timed by the same code), and
``--bitpack-sweep`` its default and stamped builds (``bitpack_sweep``). Any failure exits
non-zero before the last line; without CUDA, or without the port package
beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import http.client
import io
import json
import os
import struct
import sys
import threading
import time
import traceback
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
# H100 SXM int32 peak outside the tensor cores: 132 SMs x 64 INT32 lanes
# x 1.98 GHz boost (Hopper architecture white paper); used only to state
# what the dense formulation's op count would take at that peak
INT32_OPS_PER_S = 132 * 64 * 1.98e9
TILE = 512
LANES = 32
# filter geometries at the CUDA kernel's edges (shape, dtype)
FILTER_EDGES = {
    "pixel_1x1": ((1, 1, 1), np.uint16),
    "h17_u16": ((3, 17, 512), np.uint16),     # row groups straddle lanes, end short
    "rows_u8": ((7, 11, 600), np.uint8),
    "rgb16_w21": ((2, 5, 21, 3), np.uint16),  # bpp 6, rows of 126 bytes
    "u16_1024": ((4, 8, 1024), np.uint16),
    "rgba16": ((2, 6, 9, 4), np.uint16),      # bpp 8
    "rgb16_w16": ((2, 7, 16, 3), np.uint16),  # bpp 6, rows of 96 bytes
    "rgba8_w36": ((3, 5, 36, 4), np.uint8),   # bpp 4, rows of 144 bytes
    "rgba16_w400": ((1, 4, 400, 4), np.uint16),  # 3,200-byte rows
    "row_80kb": ((1, 3, 40000), np.uint16),   # 157 column steps, the last ragged
}
COOKIE = {"Cookie": "sessionid=chip-smoke"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# fixture
# ---------------------------------------------------------------------------


def make_field(size: int, seed: int) -> np.ndarray:
    """Smooth field + noise (compresses like microscopy, unlike white
    noise): (size, size) uint16."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    base = 2000 + 1500 * np.sin(xx / 97.0) + 1500 * np.cos(yy / 131.0)
    return (base + rng.normal(0, 120, (size, size))).clip(0, 65535).astype(np.uint16)


def make_stack(size: int, seed: int) -> np.ndarray:
    """Three channels of four z planes, each channel its own smooth field
    drifting over z, plus noise: (3, 4, size, size) uint16."""
    rng = np.random.default_rng(seed + 7)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = np.empty((3, 4, size, size), np.uint16)
    for c, (level, amp, px, py) in enumerate(((9000, 7000, 61.0, 83.0),
                                              (20000, 15000, 149.0, 37.0),
                                              (30000, 25000, 211.0, 173.0))):
        for z in range(4):
            field = level + amp * np.sin(xx / px + 0.7 * z) * np.cos(yy / py - 0.4 * z)
            out[c, z] = (field + rng.normal(0, 400, (size, size))).clip(0, 65535)
    return out


def write_fixture(data: np.ndarray, stack: np.ndarray) -> str:
    """Image 1 (the plane) and image 2 (the stack) and their registry."""
    from omero_ms_pixel_buffer_tpu_torch.io.ometiff import write_ome_tiff

    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "smoke.ome.tiff")
    write_ome_tiff(path, data[None, None, None], tile_size=(TILE, TILE),
                   compression="zlib")
    stack_path = os.path.join(WORK, "render.ome.tiff")
    write_ome_tiff(stack_path, stack[None], tile_size=(TILE, TILE), compression="zlib")
    registry = os.path.join(WORK, "registry.json")
    with open(registry, "w") as f:
        json.dump({"images": [{"id": 1, "path": path, "name": "smoke"},
                              {"id": 2, "path": stack_path, "name": "render"}]}, f)
    return registry


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call on the card (CUDA events around a run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(torch, fn, name: str, iters: int = 10, before=None):
    """Mean device time of the kernels whose name contains ``name``
    over ``iters`` calls, from torch.profiler's CUDA trace; None when the
    profiler records no device time for them. ``before`` runs ahead of
    each call (its kernels must not match ``name``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if name in ev.key:
            total += getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
            count += ev.count
    return total / count / 1e3 if count and total else None


def call_device_ms(torch, fn, iters: int = 10):
    """Device time of one call of ``fn``: every kernel and memset it issues,
    summed from torch.profiler's CUDA trace over ``iters`` calls and
    divided by ``iters``; None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
                for ev in prof.key_averages())
    return total / iters / 1e3 if total else None


def device_breakdown(torch, fn, top: int = 10, iters: int = 1) -> dict:
    """Device milliseconds of one call of ``fn`` in total and for its
    ``top`` most expensive kernels (torch.profiler's CUDA trace over
    ``iters`` calls, divided by ``iters``; ``n`` counts over all of them)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if t:
            rows.append((t / 1e3 / iters, ev.count, ev.key[:60]))
    rows.sort(reverse=True)
    return {"total": sum(r[0] for r in rows),
            "top": [{"ms": ms, "n": n, "kernel": k} for ms, n, k in rows[:top]]}


def lane_tiles(data: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    size = data.shape[0]
    ys = rng.integers(0, (size - TILE) // 64 + 1, LANES) * 64
    xs = rng.integers(0, (size - TILE) // 64 + 1, LANES) * 64
    return np.stack([data[y:y + TILE, x:x + TILE] for y, x in zip(ys, xs)])


def check_edges(torch, device, seed: int) -> dict:
    """Both tile packers (scalar-prefetch and dense) against their plain
    versions on every edge case, and on one lane whose total passes 2^31
    bits (64-bit offsets and look-back values): {packer: {case:
    max_abs_err}}; raises on any difference."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import (
        pack_tokens_sp,
        pack_tokens_sp_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack_dense import (
        pack_tokens_dense,
        pack_tokens_dense_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack_edges import SP_EDGES, sp_edge_case

    packers = {"bitpack": (pack_tokens_sp, pack_tokens_sp_plain),
               "bitpack_dense": (pack_tokens_dense, pack_tokens_dense_plain)}
    errs = {k: {} for k in packers}

    def hold(name, bt, nt, maxbits):
        for k, (pack, plain) in packers.items():
            got, want = pack(bt, nt, maxbits), plain(bt, nt, maxbits)
            torch.cuda.synchronize()
            errs[k][name] = int((got[0].to(torch.int64) - want[0].to(torch.int64)).abs().max().item())
            require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                    f"{k} kernel != plain for {name}")
            del got, want

    for name in SP_EDGES:
        b, n, maxbits = sp_edge_case(name, seed)
        hold(name, torch.from_numpy(b).to(device), torch.from_numpy(n).to(device), maxbits)
    # one lane of 103 M 21-bit tokens: 2,163,000,000 bits, past 2^31
    ntok = 103_000_000
    gen = torch.Generator(device=device).manual_seed(seed)
    bt = torch.randint(0, 1 << 21, (1, ntok), generator=gen, device=device, dtype=torch.int32)
    nt = torch.full((1, ntok), 21, dtype=torch.int32, device=device)
    require(int(nt.sum(dtype=torch.int64)) > 1 << 31, "big lane total not past 2^31")
    hold("lane_past_2e31_bits", bt, nt, -(-ntok * 21 // 1024) * 1024 + 1024)
    del bt, nt
    torch.cuda.empty_cache()
    return errs


def pass2_tokens(torch, device, tiles: np.ndarray):
    """The real ``dynamic`` pass-2 tokens of 32 lanes: (bits, nbits,
    maxbits) on the card, and what framing and inflating them needs."""
    from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as dd
    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor

    u16 = bits_tensor(tiles).to(device)
    row_bytes = 1 + TILE * 2
    flat, counts, extras, real = dd.fused_filter_histogram_batch(u16, TILE, row_bytes, 2)
    tables = dd.build_dynamic_tables(counts.cpu().numpy(), extras.cpu().numpy(), real=real)
    bits, nbits = dd.emit_tokens(flat, dd.tables_from_numpy(tables, device))
    return bits, nbits, dd._packing_maxbits(flat.shape[1]), (flat, real, tables)


def rle_tokens(torch, device, tiles: np.ndarray):
    """The real ``rle`` (fixed-Huffman) tokens of 32 lanes: (bits, nbits,
    maxbits) on the card."""
    from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as dd
    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor

    u16 = bits_tensor(tiles).to(device)
    flat = dd.fused_filter_histogram_batch(u16, TILE, 1 + TILE * 2, 2)[0]
    bits, nbits = dd._lane_tokens(flat)
    return bits, nbits, dd._packing_maxbits(flat.shape[1])


def packer_time(torch, device, tiles: np.ndarray, dense: bool) -> dict:
    """One packer alone: the scalar-prefetch packer on the real ``dynamic``
    pass-2 tokens, or the dense packer on the real ``rle`` tokens. Device
    time per call over everything a call issues, the wrapper's call time,
    the device kernels by name, byte equality with the plain version."""
    if dense:
        from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack_dense import (
            pack_tokens_dense as pack,
            pack_tokens_dense_plain as plain,
        )

        bits, nbits, maxbits = rle_tokens(torch, device, tiles)
    else:
        from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import (
            pack_tokens_sp as pack,
            pack_tokens_sp_plain as plain,
        )

        bits, nbits, maxbits, _ = pass2_tokens(torch, device, tiles)
    got, want = pack(bits, nbits, maxbits), plain(bits, nbits, maxbits)
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            f"{'dense' if dense else 'bitpack'} kernel != plain on its tokens")
    call = lambda: pack(bits, nbits, maxbits)  # noqa: E731
    return {"phase": "dense_time" if dense else "bitpack_time",
            "package": os.path.dirname(os.path.dirname(
                sys.modules["omero_ms_pixel_buffer_tpu_torch"].__file__)),
            "shape": list(bits.shape), "maxbits": maxbits,
            "device_ms_per_call": [call_device_ms(torch, call, iters=20) for _ in range(3)],
            "call_ms": [time_ms(torch, call) for _ in range(3)],
            "by_kernel": device_breakdown(torch, call)}


def bitpack_sweep(torch, device, tiles: np.ndarray, seed: int) -> None:
    """Emit the scalar-prefetch kernel's two builds, the default (through
    the wrapper) and the one with ``%globaltimer`` stamps (the C entry
    ``ompb_sp_pack_stamped``, see ``csrc/bitpack.cu``), with their device
    time per call (kernel and memset), the CTAs' phase times from one
    stamped call, and every case, three runs each, where one differs from
    the plain version (the real pass-2 tokens and every edge case); then
    fail if any did."""
    import ctypes

    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import _build
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import (
        pack_tokens_sp,
        pack_tokens_sp_plain,
        sp_tiles,
        sp_workspace_bytes,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack_edges import SP_EDGES, sp_edge_case

    fn = _build.entry("bitpack", "ompb_sp_pack_stamped",
                      [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_longlong, ctypes.c_longlong,
                                               ctypes.c_void_p, ctypes.c_void_p])

    def stamped(bits, nbits, maxbits, stamps):
        B, ntok = bits.shape
        ws_bytes = sp_workspace_bytes(B, ntok)
        out = torch.empty((B, maxbits // 32), dtype=torch.int32, device=device)
        totals = torch.empty((B,), dtype=torch.int64, device=device)
        ws = torch.empty((ws_bytes,), dtype=torch.uint8, device=device)
        _build.check(fn(bits.data_ptr(), nbits.data_ptr(), out.data_ptr(), totals.data_ptr(),
                        ws.data_ptr(), ws_bytes, B, ntok, maxbits // 32,
                        _build.stream_handle(device), stamps.data_ptr()),
                     "bitpack stamped build")
        return out.view(torch.uint8), totals

    def phases():
        """Per-CTA phase times (us) of one stamped call: median and p90."""
        n = bits.shape[0] * sp_tiles(bits.shape[1])
        stamps = torch.zeros((n, 8), dtype=torch.int64, device=device)
        stamped(bits, nbits, maxbits, stamps)
        st = stamps.cpu().numpy()
        t = st[:, :7].astype(np.float64) / 1e3
        names = ["ticket", "tokens_scanned", "prefix_known", "strip_built",
                 "handover_thread0", "stores_to_end"]
        deltas = {k: t[:, i + 1] - t[:, i] for i, k in enumerate(names[:4])}
        deltas["handover_thread0"] = t[:, 5] - t[:, 4]
        deltas["stores_to_end"] = t[:, 6] - t[:, 4]
        life = t[:, 6] - t[:, 0]
        span = t[:, 6].max() - t[:, 0].min()
        return {"ctas": int(n), "span_us": float(span),
                "mean_resident_ctas": float(life.sum() / span),
                "sms": int(len(np.unique(st[:, 7]))),
                "last_entry_to_end_us": float(t[:, 6].max() - t[:, 0].max()),
                "lifetime_us": [float(np.median(life)), float(np.percentile(life, 90))],
                "phase_us_median_p90": {k: [float(np.median(v)), float(np.percentile(v, 90))]
                                        for k, v in deltas.items()}}

    bits, nbits, maxbits, _ = pass2_tokens(torch, device, tiles)
    want = pack_tokens_sp_plain(bits, nbits, maxbits)
    edges = {}
    for k in SP_EDGES:
        b, n, m = sp_edge_case(k, seed)
        edges[k] = (torch.from_numpy(b).to(device), torch.from_numpy(n).to(device), m)
    edge_want = {k: pack_tokens_sp_plain(*v) for k, v in edges.items()}
    cases = {"pass2": (bits, nbits, maxbits), **edges}
    wants = {"pass2": want, **edge_want}

    def diff(got, want) -> dict:
        bad = (got[0] != want[0]).nonzero()
        return {"lane_byte": bad[0].tolist() if len(bad) else None, "bytes": len(bad),
                "totals_equal": bool(torch.equal(got[1], want[1]))}

    table, failures = [], {}
    most = max(v[0].shape[0] * sp_tiles(v[0].shape[1]) for v in cases.values())
    stamps = torch.zeros((most, 8), dtype=torch.int64, device=device)
    builds = {"default": pack_tokens_sp,
              "stamped": lambda b, n, m: stamped(b, n, m, stamps)}
    for build, pack in builds.items():
        for k, v in cases.items():
            for rep in range(3):
                got = pack(*v)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], wants[k][0]) and torch.equal(got[1], wants[k][1])):
                    failures.setdefault(f"{build}/{k}", []).append(diff(got, wants[k]))
        call = lambda: pack(bits, nbits, maxbits)  # noqa: E731
        table.append({"build": build,
                      "device_ms_per_call": [call_device_ms(torch, call, iters=20)
                                             for _ in range(3)]})
    table[1]["phases"] = phases()
    emit({"phase": "bitpack_sweep", "shape": list(bits.shape), "maxbits": maxbits,
          "table": table, "failures": failures})
    require(not failures, f"bitpack builds differ from plain: {sorted(failures)}")


def check_kernels(torch, device, tiles: np.ndarray, seed: int) -> list:
    from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as dd
    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import (
        pack_tokens_sp,
        pack_tokens_sp_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack_dense import (
        OPS_PER_TOKEN,
        pack_tokens_dense,
        pack_tokens_dense_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.filter import (
        filter_tiles,
        filter_tiles_plain,
    )

    def max_err(a, b) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())

    u16 = bits_tensor(tiles).to(device)
    rng = np.random.default_rng(7)
    cases = {f"u16_{m}": (u16, m) for m in ("none", "sub", "up", "average", "paeth")}
    cases["u8_up"] = (bits_tensor((tiles >> 4).astype(np.uint8)).to(device), "up")
    rgb = rng.integers(0, 256, (LANES, TILE, TILE, 3), dtype=np.uint8)
    cases["rgb8_paeth"] = (bits_tensor(rgb).to(device), "paeth")
    # RGB16 lanes (bpp 6) at the whole-slide tile shape
    rgb16 = rng.integers(0, 65536, (LANES, 256, 256, 3), dtype=np.uint16)
    for m in ("up", "paeth"):
        cases[f"rgb16_256_{m}"] = (bits_tensor(rgb16).to(device), m)
    # the kernel's edges: groups of scanlines that straddle lanes or end
    # short, rows that are not a multiple of 16 bytes and a misaligned
    # input (its byte-load branch), wide rows with a ragged last step
    for name, (shape, dtype) in FILTER_EDGES.items():
        info = np.iinfo(dtype)
        x = bits_tensor(rng.integers(info.min, info.max, shape, dtype=dtype,
                                     endpoint=True)).to(device)
        for m in ("none", "sub", "up", "average", "paeth"):
            cases[f"{name}_{m}"] = (x, m)
    flat = torch.from_numpy(rng.integers(0, 256, 1 + 5 * 19 * 37 * 3, dtype=np.uint8))
    misaligned = flat.to(device)[1:].view(5, 19, 37, 3)
    require(misaligned.data_ptr() % 16 == 1, "misaligned case is aligned")
    for m in ("none", "sub", "up", "average", "paeth"):
        cases[f"misaligned_rgb8_{m}"] = (misaligned, m)
    filter_errs = {}
    for name, (x, mode) in cases.items():
        got, want = filter_tiles(x, mode), filter_tiles_plain(x, mode)
        torch.cuda.synchronize()
        filter_errs[name] = max_err(got, want)
        require(torch.equal(got, want), f"filter kernel != plain for {name}")
    f_call = time_ms(torch, lambda: filter_tiles(u16, "up"))
    f_ms = kernel_ms(torch, lambda: filter_tiles(u16, "up"), "filter_row_groups")
    # cold: a 256 MB buffer zeroed before each launch flushes the 50 MB L2
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    f_cold = kernel_ms(torch, lambda: filter_tiles(u16, "up"), "filter_row_groups",
                       before=flush.zero_)
    del flush
    f_plain = time_ms(torch, lambda: filter_tiles_plain(u16, "up"))
    f_bytes = u16.numel() * 2 + LANES * TILE * (1 + TILE * 2)

    # the packer on the real pass-2 tokens of these lanes
    row_bytes = 1 + TILE * 2
    bits, nbits, maxbits, (flat, real, tables) = pass2_tokens(torch, device, tiles)
    got_p, got_t = pack_tokens_sp(bits, nbits, maxbits)
    want_p, want_t = pack_tokens_sp_plain(bits, nbits, maxbits)
    torch.cuda.synchronize()
    require(torch.equal(got_p, want_p) and torch.equal(got_t, want_t),
            "bitpack kernel != plain on pass-2 tokens")
    flat_np = flat.cpu().numpy()

    def inflate_all(packed, body_bits, eob_bits, what):
        streams, lengths = dd._frame_lanes(flat, packed, body_bits, eob_bits=eob_bits)
        streams_np, lengths_np = streams.cpu().numpy(), lengths.cpu().numpy()
        for i in range(real):
            require(zlib.decompress(streams_np[i, : lengths_np[i]].tobytes())
                    == flat_np[i].tobytes(), f"lane {i} {what} stream does not inflate back")
        return lengths_np[:real]

    lengths_np = inflate_all(got_p, got_t, 0, "dynamic")

    # the dense packer on the real rle (fixed-Huffman) tokens of these lanes
    rbits, rnbits = dd._lane_tokens(flat)
    got_d, got_dt = pack_tokens_dense(rbits, rnbits, maxbits)
    want_d, want_dt = pack_tokens_dense_plain(rbits, rnbits, maxbits)
    sp_d, sp_dt = pack_tokens_sp(rbits, rnbits, maxbits)
    torch.cuda.synchronize()
    require(torch.equal(got_d, want_d) and torch.equal(got_dt, want_dt),
            "dense bitpack kernel != plain on rle tokens")
    require(torch.equal(got_d, sp_d) and torch.equal(got_dt, sp_dt),
            "dense bitpack kernel != scalar-prefetch kernel on rle tokens")
    require(torch.equal(pack_tokens_dense(rbits, rnbits, 1 << 20)[0],
                        pack_tokens_dense_plain(rbits, rnbits, 1 << 20)[0]),
            "dense bitpack kernel != plain when truncated at 2^20 bits")
    rle_lengths_np = inflate_all(got_d, got_dt, 7, "rle")
    # device time of one whole 32-lane group (both passes), by kernel
    def group():
        f, c, e, r = dd.fused_filter_histogram_batch(u16, TILE, row_bytes, 2)
        dd.dynamic_emit(f, dd.tables_from_numpy(tables, device))

    group_top = device_breakdown(torch, group)
    edge_errs = check_edges(torch, device, seed)
    sp_errs, dense_errs = edge_errs["bitpack"], edge_errs["bitpack_dense"]
    b_call = time_ms(torch, lambda: pack_tokens_sp(bits, nbits, maxbits))
    # device time per call: the kernel and the memset of its tile records
    b_ms = call_device_ms(torch, lambda: pack_tokens_sp(bits, nbits, maxbits))
    b_kernel = kernel_ms(torch, lambda: pack_tokens_sp(bits, nbits, maxbits), "sp_pack_tiles")
    b_plain = time_ms(torch, lambda: pack_tokens_sp_plain(bits, nbits, maxbits), iters=5)
    b_bytes = 8 * bits.numel() + bits.shape[0] * maxbits // 8
    d_call = time_ms(torch, lambda: pack_tokens_dense(rbits, rnbits, maxbits))
    # device time per call: the kernel and the memset of its tile records
    d_ms = call_device_ms(torch, lambda: pack_tokens_dense(rbits, rnbits, maxbits))
    d_kernel = kernel_ms(torch, lambda: pack_tokens_dense(rbits, rnbits, maxbits),
                         "dense_pack_tiles")
    d_plain = time_ms(torch, lambda: pack_tokens_dense_plain(rbits, rnbits, maxbits),
                      iters=2, warmup=1)
    d_bytes = 8 * rbits.numel() + rbits.shape[0] * maxbits // 8
    d_ops = OPS_PER_TOKEN * rbits.numel()
    emit({"phase": "kernels", "filter_cases_max_abs_err": filter_errs,
          "group_device_ms": group_top,
          "bitpack": {"lanes": int(bits.shape[0]), "ntok": int(bits.shape[1]),
                      "edge_cases_max_abs_err": sp_errs, "kernel_only_ms": b_kernel,
                      "maxbits": maxbits, "body_bits_mean": float(got_t.float().mean()),
                      "stream_bytes_mean": float(lengths_np.mean())},
          "bitpack_dense": {"lanes": int(rbits.shape[0]), "ntok": int(rbits.shape[1]),
                            "edge_cases_max_abs_err": dense_errs,
                            "kernel_only_ms": d_kernel, "maxbits": maxbits,
                            "body_bits_mean": float(got_dt.float().mean()),
                            "rle_stream_bytes_mean": float(rle_lengths_np.mean()),
                            # derived, not measured: the dense formulation's
                            # int op count and that count at the int32 peak
                            "formulation_ops": d_ops,
                            "formulation_ops_at_int32_peak_ms":
                                d_ops / INT32_OPS_PER_S * 1e3}})
    return [
        {"name": "filter", "route": "cuda",
         "source": "omero_ms_pixel_buffer_tpu_torch/csrc/filter.cu",
         "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/filter.py:137",
         "max_abs_err": max(filter_errs.values()), "ms": f_ms if f_ms else f_call,
         "ms_from": "profiler" if f_ms else "events", "cold_ms": f_cold,
         "call_ms": f_call, "plain_ms": f_plain,
         "bound_ms": f_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
        {"name": "bitpack", "route": "cuda",
         "source": "omero_ms_pixel_buffer_tpu_torch/csrc/bitpack.cu",
         "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/bitpack.py:201",
         "max_abs_err": max(max_err(got_p, want_p), *sp_errs.values()),
         "ms": b_ms if b_ms else b_call,
         "ms_from": "profiler" if b_ms else "events", "call_ms": b_call, "plain_ms": b_plain,
         "bound_ms": b_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
        {"name": "bitpack_dense", "route": "cuda",
         "source": "omero_ms_pixel_buffer_tpu_torch/csrc/bitpack_dense.cu",
         "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/bitpack.py:275",
         "max_abs_err": max(max_err(got_d, want_d), *dense_errs.values()),
         "ms": d_ms if d_ms else d_call,
         "ms_from": "profiler" if d_ms else "events", "call_ms": d_call, "plain_ms": d_plain,
         "bound_ms": d_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
         "library_ms": None},
    ]


def filter_sweep(torch, device, tiles: np.ndarray) -> dict:
    """Device ms of the filter kernel on the main path's 32 lanes over
    the rows a warp owns (``group_bytes`` of output, rounded up to whole
    rows), mode Up, warm and with the L2 flushed, each checked byte-equal
    to the plain version (through the C entry ``ompb_filter_tuned``);
    then every mode at the default, through the wrapper."""
    import ctypes

    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import _build
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.filter import (
        filter_tiles,
        filter_tiles_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.png import FILTER_CODES

    fn = _build.entry("filter", "ompb_filter_tuned",
                      [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7
                      + [ctypes.c_void_p])
    u16 = bits_tensor(tiles).to(device)
    want = filter_tiles_plain(u16, "up")
    out = torch.empty_like(want)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    rows, width = u16.shape[0] * u16.shape[1], u16.shape[2]

    def run(group_bytes):
        _build.check(fn(u16.data_ptr(), out.data_ptr(), rows, u16.shape[1], width, 1, 2,
                        FILTER_CODES["up"], group_bytes, _build.stream_handle(device)),
                     "filter sweep")

    table = []
    for group_bytes in (1024, 2048, 4096, 8192, 16384, 32768):
        out.zero_()
        run(group_bytes)
        torch.cuda.synchronize()
        require(torch.equal(out, want), f"filter sweep {group_bytes} != plain")
        table.append({
            "group_bytes": group_bytes,
            "ms": kernel_ms(torch, lambda: run(group_bytes), "filter_row_groups"),
            "cold_ms": kernel_ms(torch, lambda: run(group_bytes), "filter_row_groups",
                                 before=flush.zero_),
        })
    modes = {m: {"ms": kernel_ms(torch, lambda: filter_tiles(u16, m), "filter_row_groups"),
                 "cold_ms": kernel_ms(torch, lambda: filter_tiles(u16, m), "filter_row_groups",
                                      before=flush.zero_)}
             for m in FILTER_CODES}
    return {"phase": "filter_sweep", "shape": list(u16.shape), "mode": "up", "table": table,
            "modes": modes}


# ---------------------------------------------------------------------------
# the served path
# ---------------------------------------------------------------------------


def decode_png(body: bytes) -> np.ndarray:
    """Grayscale 8/16-bit or RGB8 PNG -> array, with zlib and a numpy
    unfilter (filter types none and up: what the service emits)."""
    require(body[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat = 8, b""
    while pos < len(body):
        (n,) = struct.unpack(">I", body[pos:pos + 4])
        tag, data = body[pos + 4:pos + 8], body[pos + 8:pos + 8 + n]
        require(zlib.crc32(tag + data) & 0xFFFFFFFF
                == struct.unpack(">I", body[pos + 8 + n:pos + 12 + n])[0], "bad CRC")
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", data[:10])
        elif tag == b"IDAT":
            idat += data
        pos += 12 + n
    require((color, depth) in ((0, 8), (0, 16), (2, 8)), "unexpected PNG format")
    samples = 3 if color == 2 else 1
    rb = w * samples * depth // 8
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + rb)
    require(np.isin(rows[:, 0], (0, 2)).all(), "unexpected PNG filter type")
    res = rows[:, 1:].copy()
    up = rows[:, 0] == 2
    out = np.zeros_like(res)
    prev = np.zeros(rb, np.uint8)
    for y in range(h):  # row-serial: each up row adds the row above
        out[y] = res[y] + prev if up[y] else res[y]
        prev = out[y]
    if samples == 3:
        return out.reshape(h, w, 3)
    return out.view(">u2" if depth == 16 else np.uint8).reshape(h, w)


class Client:
    """Keep-alive HTTP connections, one per worker thread."""

    def __init__(self, port: int):
        self.port = port
        self._local = threading.local()
        self._conns = []
        self._lock = threading.Lock()

    def close(self) -> None:
        with self._lock:
            for conn in self._conns:
                conn.close()
            self._conns.clear()

    def request(self, method: str, path: str, headers=None):
        """(status, headers, body, seconds) of one request on this
        thread's connection, with the session cookie."""
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._local.conn = http.client.HTTPConnection(
                "127.0.0.1", self.port, timeout=120)
            with self._lock:
                self._conns.append(conn)
        t0 = time.perf_counter()
        conn.request(method, path, headers={**COOKIE, **(headers or {})})
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, dict(resp.getheaders()), body, time.perf_counter() - t0

    def get(self, path: str):
        status, _, body, seconds = self.request("GET", path)
        return status, body, seconds


def run_requests(client: Client, reqs, concurrency: int):
    with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
        t0 = time.perf_counter()
        out = list(pool.map(lambda r: client.get(r[0]), reqs))
        return out, time.perf_counter() - t0


def tile_requests(rng, size: int, n: int):
    reqs = []
    for _ in range(n):
        x = int(rng.integers(0, (size - TILE) // 64 + 1)) * 64
        y = int(rng.integers(0, (size - TILE) // 64 + 1)) * 64
        reqs.append((f"/tile/1/0/0/0?x={x}&y={y}&w={TILE}&h={TILE}&format=png",
                     (x, y, TILE, TILE), 200))
    return reqs


def edge_requests(size: int):
    def req(x, y, w, h, status=200):
        return (f"/tile/1/0/0/0?x={x}&y={y}&w={w}&h={h}&format=png", (x, y, w, h), status)

    return [
        req(64, 128, 300, 200), req(size // 8, size * 3 // 8, 300, 200),
        req(5, 7, 17, 511),
        req(size - 300, 640, 300, 200),        # ends at the right edge
        req(512, size - 200, 300, 200),        # ends at the bottom edge
        req(size - TILE // 2, 0, TILE, TILE, 404),  # crosses the right edge
        req(0, 0, 100, 100, 200),
    ]


def get_json(client: Client, path: str) -> dict:
    status, body, _ = client.get(path)
    require(status == 200, f"{path} answered {status}")
    return json.loads(body)


def verify(results, reqs, data: np.ndarray) -> int:
    checked = 0
    for (status, body, _), (path, (x, y, w, h), want) in zip(results, reqs):
        require(status == want, f"{path} answered {status}, expected {want}")
        if status == 200:
            require(np.array_equal(decode_png(body), data[y:y + h, x:x + w]),
                    f"{path}: pixels differ from the source")
            checked += 1
    return checked


def png_stream_len(body: bytes) -> int:
    """Bytes of a PNG's zlib stream (its IDAT chunks)."""
    pos, n_idat = 8, 0
    while pos < len(body):
        (n,) = struct.unpack(">I", body[pos:pos + 4])
        if body[pos + 4:pos + 8] == b"IDAT":
            n_idat += n
        pos += 12 + n
    return n_idat


def timed_window(health_before: dict, health_after: dict, seconds: float) -> dict:
    """The encode queue over the timed requests alone: the difference of
    two ``/healthz`` views taken just before and just after them.
    ``*_busy_share`` is the share of the window's wall time that the
    submit thread (stage) and the readback thread (every other stage)
    spent on its groups; ``result_cache_hits`` and ``lone_lanes`` count
    the requests that bypassed the device (a cache hit, or a batch of one
    encoded on the host)."""
    before, after = health_before["queue"], health_after["queue"]
    groups = after["completed"] - before["completed"]
    total = {k: v - before["stage_ms_total"].get(k, 0.0)
             for k, v in after["stage_ms_total"].items()}
    n = {k: v - before["stage_groups"].get(k, 0) for k, v in after["stage_groups"].items()}
    readback_ms = sum(v for k, v in total.items() if k != "stage")
    return {
        "groups": groups,
        "lanes": after["lanes"] - before["lanes"],
        "seconds": seconds,
        "stage_ms_mean": {k: total[k] / n[k] for k in total if n[k]},
        "submit_busy_share": total.get("stage", 0.0) / 1e3 / seconds,
        "readback_busy_share": readback_ms / 1e3 / seconds,
        "result_cache_hits": (health_after["result_cache"]["memory"]["hits"]
                              - health_before["result_cache"]["memory"]["hits"]),
        "lone_lanes": health_after["batcher"]["lone"] - health_before["batcher"]["lone"],
        "host_png_lanes": health_after["host_png_lanes"] - health_before["host_png_lanes"],
        "render_host_lanes": (health_after["render"]["host_lanes"]
                              - health_before["render"]["host_lanes"]),
        "render_groups": after["render_groups"] - before["render_groups"],
        "supertile": supertile_delta(health_before, health_after),
    }


def supertile_delta(health_before: dict, health_after: dict) -> dict:
    """The super-tile counts of ``/healthz`` between two views."""
    before, after = health_before["supertile"], health_after["supertile"]
    return {k: after[k] - before[k]
            for k in ("stamped_lanes", "groups", "encode_groups", "device_lanes",
                      "host_lanes", "fallback_lanes", "host_pulls")}


def drive_path(registry: str, data: np.ndarray, seed: int, n_requests: int,
               deflate_mode: str, packer: str, launched, idle, warm_rounds: int = 2,
               edges: bool = True, device: str = "cuda", phase: str = "") -> dict:
    """Serve ``n_requests`` timed 512x512 PNG tiles (after ``warm_rounds``
    rounds of 32, then the edge cases) from a fresh server in
    ``deflate_mode`` with ``packer``, every body pixel-checked. The
    kernels in ``launched`` must have launched in the run, those in
    ``idle`` not."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    with ServerThread(registry, device=device, deflate_mode=deflate_mode,
                      packer=packer) as client:
        size = data.shape[0]
        rng = np.random.default_rng(seed + 2)
        reset_launch_counts()
        # warm-up rounds: the plane is admitted on its second touch
        warm = tile_requests(rng, size, warm_rounds * LANES)
        t_warm = time.perf_counter()
        warm_out = []
        for k in range(warm_rounds):
            warm_out += run_requests(client, warm[k * LANES:(k + 1) * LANES], LANES)[0]
        warm_s = time.perf_counter() - t_warm
        main = tile_requests(rng, size, n_requests)
        before = get_json(client, "/healthz")
        main_out, main_s = run_requests(client, main, LANES)
        window = timed_window(before, get_json(client, "/healthz"), main_s)
        edge_reqs = edge_requests(size) if edges else []
        edge_out = run_requests(client, edge_reqs, len(edge_reqs))[0] if edges else []
        launches = launch_counts()
        health = get_json(client, "/healthz")
    checked = (verify(warm_out, warm, data) + verify(main_out, main, data)
               + verify(edge_out, edge_reqs, data))
    lat_ms = np.array([r[2] for r in main_out]) * 1e3
    require(all(launches[k] > 0 for k in launched),
            f"{deflate_mode}: a kernel of the path never launched: {launches}")
    require(all(launches[k] == 0 for k in idle),
            f"{deflate_mode}: a kernel off the path launched: {launches}")
    require(health["kernels"] == launches, "healthz counters disagree")
    require(health["queue"]["deflate_mode"] == deflate_mode
            and health["queue"]["packer"] == packer, f"served with {health['queue']}")
    require(health["queue"]["failed"] == 0, f"encode groups failed: {health['queue']}")
    return {
        "phase": phase or ("path" if deflate_mode == "dynamic" else f"path_{deflate_mode}"),
        "deflate_mode": deflate_mode, "packer": packer,
        "tiles_verified": checked, "launches": launches,
        "requests": n_requests, "concurrency": LANES,
        "tiles_per_s": n_requests / main_s, "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)), "warmup_s": warm_s,
        "stream_bytes_mean": float(np.mean([png_stream_len(r[1]) for r in main_out])),
        "timed_window": window,
        "plane_cache": health["plane_cache"], "queue": health["queue"],
        "batcher": health["batcher"], "result_cache": health["result_cache"],
        "host_engine": health["host_engine"], "gpu": health["gpu"],
    }


class ServerThread:
    """The service (``create_server``) on 127.0.0.1 in this process, its
    event loop on a thread of its own; a context manager that closes it."""

    def __init__(self, registry: str, **kwargs):
        from omero_ms_pixel_buffer_tpu_torch.http.server import create_server

        self.server = create_server(registry, dev=True, **kwargs)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="smoke-server",
                                       daemon=True)

    def __enter__(self) -> Client:
        self.thread.start()
        port = asyncio.run_coroutine_threadsafe(
            self.server.start("127.0.0.1", 0), self.loop).result(120)
        self.client = Client(port)
        return self.client

    def __exit__(self, *exc) -> None:
        self.client.close()
        asyncio.run_coroutine_threadsafe(self.server.close(), self.loop).result(120)
        self.server.pipeline.close()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)


def http_contract(registry: str, data: np.ndarray, device: str = "cuda") -> dict:
    """The front's contract with the JAX package on the card's server: a
    lone request answered with host bytes, lanes larger than every bucket
    answered with the host engine's bytes, ETag / Cache-Control / X-Cache,
    304 on a matching If-None-Match (not on ``*``), HEAD, OPTIONS and an
    unrouted GET's 405."""
    from omero_ms_pixel_buffer_tpu_torch.cache.result_cache import make_etag
    from omero_ms_pixel_buffer_tpu_torch.http.server import DISCOVERY
    from omero_ms_pixel_buffer_tpu_torch.ops.png import encode_png
    from omero_ms_pixel_buffer_tpu_torch.runtime.native import get_engine

    def url(x, y, w, h):
        return f"/tile/1/0/0/0?x={x}&y={y}&w={w}&h={h}&format=png"

    with ServerThread(registry, device=device) as client:
        health0 = get_json(client, "/healthz")
        engine = health0["host_engine"]
        require(engine == ("native" if get_engine() is not None else "python"),
                f"/healthz names host engine {engine}")
        # a lone request: the single-request path's host bytes
        x, y = data.shape[1] // 8, data.shape[0] // 4
        status, hdr, body, _ = client.request("GET", url(x, y, TILE, TILE))
        require(status == 200 and body == encode_png(data[y:y + TILE, x:x + TILE]),
                "a lone request was not answered with host bytes")
        etag = hdr.get("ETag")
        require(etag == make_etag(body) and hdr.get("X-Cache") == "miss"
                and hdr.get("Cache-Control") == "private, max-age=60",
                f"miss headers: {hdr}")
        require(get_json(client, "/healthz")["batcher"]["lone"] == health0["batcher"]["lone"] + 1,
                "the lone request was not counted as a batch of one")
        status, hdr2, body2, _ = client.request("GET", url(x, y, TILE, TILE))
        require(status == 200 and body2 == body and hdr2.get("ETag") == etag
                and hdr2.get("X-Cache") == "hit", f"hit headers: {hdr2}")
        for inm in (etag, "W/" + etag, '"other", ' + etag):
            status, hdr3, body3, _ = client.request("GET", url(x, y, TILE, TILE),
                                                    {"If-None-Match": inm})
            require(status == 304 and body3 == b"" and hdr3.get("ETag") == etag,
                    f"If-None-Match {inm} answered {status}")
        status, _, body3, _ = client.request("GET", url(x, y, TILE, TILE), {"If-None-Match": "*"})
        require(status == 200 and body3 == body, f"If-None-Match * answered {status}")
        status, hdr4, body4, _ = client.request("HEAD", url(x, y, TILE, TILE))
        require(status == 200 and body4 == b"" and hdr4.get("ETag") == etag
                and int(hdr4.get("Content-Length", -1)) == len(body), f"HEAD: {status} {hdr4}")
        status, _, body5, _ = client.request("OPTIONS", "/anything")
        require(status == 200 and json.loads(body5) == DISCOVERY, f"OPTIONS: {status} {body5}")
        status, _, body6, _ = client.request("GET", "/tile/1/0/0")
        require((status, body6) == (405, b"405: Method Not Allowed"), f"unrouted GET: {status}")
        # two lanes larger than every bucket in one batch: the host lane
        # route (the native engine's bytes, or Python zlib without it);
        # fresh offsets until both coalesce into one batch
        for attempt in range(8):
            lanes = [(64 * attempt, 100, 1100, 300), (64 * attempt, 600, 1100, 300)]
            host0 = get_json(client, "/healthz")["host_png_lanes"]
            out = run_requests(client, [(url(*r), r, 200) for r in lanes], 2)[0]
            verify(out, [(url(*r), r, 200) for r in lanes], data)
            if get_json(client, "/healthz")["host_png_lanes"] == host0 + 2:
                break
        else:
            raise SmokeFailure("the oversize lanes never coalesced into one batch")
        for (_, got, _), (lx, ly, lw, lh) in zip(out, lanes):
            tile = data[ly:ly + lh, lx:lx + lw]
            want = (get_engine().png_encode_batch([tile], "up", 6, "fast")[0]
                    if engine == "native" else encode_png(tile))
            require(got == want, "an oversize lane was not answered with host-engine bytes")
        health = get_json(client, "/healthz")
    return {"phase": "http_contract", "host_engine": engine, "oversize_attempts": attempt + 1,
            "host_png_lanes": health["host_png_lanes"], "batcher": health["batcher"],
            "result_cache": health["result_cache"]}


# ---------------------------------------------------------------------------
# the render plane
# ---------------------------------------------------------------------------

RENDER_C = "1|500:30000$FF0000,2|1000:40000$00FF00,3|0:65535$0000FF"
# the rounds after the timed requests: (name, extra query), two rounds each
RENDER_ROUNDS = [
    ("intmax", "&p=intmax|0:3"),
    ("intmean", "&p=intmean"),
    ("greyscale", "&m=g"),
    ("roi", '&roi=[{"type":"rect","x":1000,"y":900,"w":1500,"h":1400}]'),
    ("maps", '&maps=[{"reverse":{"enabled":true}},{"quantization":'
             '{"family":"logarithmic","coefficient":4}}]'),
]


def render_lanes(stack: np.ndarray, seed: int) -> np.ndarray:
    """32 lanes of (3, 512, 512) z=0 channel planes at random offsets."""
    rng = np.random.default_rng(seed + 3)
    size = stack.shape[-1]
    ys = rng.integers(0, (size - TILE) // 64 + 1, LANES) * 64
    xs = rng.integers(0, (size - TILE) // 64 + 1, LANES) * 64
    return np.stack([stack[:, 0, y:y + TILE, x:x + TILE] for y, x in zip(ys, xs)])


def check_render_kernels(torch, device, stack: np.ndarray, seed: int):
    """The filter and the scalar-prefetch packer at the render shape, and
    the composite's device time: returns (kernel rows, phase line)."""
    from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as dd
    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import (
        pack_tokens_sp,
        pack_tokens_sp_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.filter import (
        filter_tiles,
        filter_tiles_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.render import engine as rengine
    from omero_ms_pixel_buffer_tpu_torch.render.luts import LutRegistry
    from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec

    lanes = render_lanes(stack, seed)
    spec = RenderSpec.from_params({"c": RENDER_C})
    tables, luts = rengine.build_tables(spec, np.dtype(np.uint16), LutRegistry())
    planes = bits_tensor(lanes).to(device)
    packed = torch.from_numpy(rengine.packed_rgb_tables(tables, luts)).to(device)
    rgb = rengine.render_torch(planes, tables, luts, packed=packed)
    want_rgb = np.stack([rengine.render_host(lane, tables, luts) for lane in lanes[:4]])
    require(np.array_equal(rgb[:4].cpu().numpy(), want_rgb), "composite != numpy host mirror")
    composite = lambda: rengine.render_torch(planes, tables, luts, packed=packed)  # noqa: E731
    c_ms = call_device_ms(torch, composite)
    c_call = time_ms(torch, composite)
    c_bytes = lanes.nbytes + rgb.numel()
    c_breakdown = device_breakdown(torch, composite)

    got, want = filter_tiles(rgb, "up"), filter_tiles_plain(rgb, "up")
    torch.cuda.synchronize()
    f_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
    require(torch.equal(got, want), "filter kernel != plain on render composites")
    f_call = time_ms(torch, lambda: filter_tiles(rgb, "up"))
    f_ms = kernel_ms(torch, lambda: filter_tiles(rgb, "up"), "filter_row_groups")
    f_plain = time_ms(torch, lambda: filter_tiles_plain(rgb, "up"))
    f_bytes = rgb.numel() + got.numel()

    row_bytes = 1 + TILE * 3
    flat = got[:, :TILE, :row_bytes].contiguous().reshape(LANES, -1)
    bits, nbits = dd._lane_tokens(flat)
    maxbits = dd._packing_maxbits(flat.shape[1])
    got_p, got_t = pack_tokens_sp(bits, nbits, maxbits)
    want_p, want_t = pack_tokens_sp_plain(bits, nbits, maxbits)
    torch.cuda.synchronize()
    b_err = int((got_p.to(torch.int64) - want_p.to(torch.int64)).abs().max().item())
    require(torch.equal(got_p, want_p) and torch.equal(got_t, want_t),
            "bitpack kernel != plain on render rle tokens")
    streams, lengths = dd._frame_lanes(flat, got_p, got_t, eob_bits=7)
    streams_np, lengths_np, flat_np = streams.cpu().numpy(), lengths.cpu().numpy(), flat.cpu().numpy()
    for i in range(LANES):
        require(zlib.decompress(streams_np[i, : lengths_np[i]].tobytes()) == flat_np[i].tobytes(),
                f"render lane {i} rle stream does not inflate back")
    call = lambda: pack_tokens_sp(bits, nbits, maxbits)  # noqa: E731
    b_call = time_ms(torch, call)
    b_ms = call_device_ms(torch, call)
    b_kernel = kernel_ms(torch, call, "sp_pack_tiles")
    b_plain = time_ms(torch, lambda: pack_tokens_sp_plain(bits, nbits, maxbits), iters=5)
    b_bytes = 8 * bits.numel() + bits.shape[0] * maxbits // 8
    line = {"phase": "kernels_render", "shape": list(rgb.shape),
            "composite": {"ms": c_ms, "call_ms": c_call, "bytes": c_bytes,
                          "bound_ms": c_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                          "by_kernel": c_breakdown},
            "bitpack": {"ntok": int(bits.shape[1]), "maxbits": maxbits,
                        "kernel_only_ms": b_kernel,
                        "body_bits_mean": float(got_t.float().mean()),
                        "stream_bytes_mean": float(lengths_np.mean())}}
    rows = [
        {"name": "filter_render_rgb8", "route": "cuda",
         "source": "omero_ms_pixel_buffer_tpu_torch/csrc/filter.cu",
         "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/filter.py:137",
         "shape": list(rgb.shape), "max_abs_err": f_err, "ms": f_ms if f_ms else f_call,
         "ms_from": "profiler" if f_ms else "events", "call_ms": f_call, "plain_ms": f_plain,
         "bound_ms": f_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None},
        {"name": "bitpack_render_rle", "route": "cuda",
         "source": "omero_ms_pixel_buffer_tpu_torch/csrc/bitpack.cu",
         "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/bitpack.py:201",
         "shape": list(bits.shape), "max_abs_err": b_err, "ms": b_ms if b_ms else b_call,
         "ms_from": "profiler" if b_ms else "events", "call_ms": b_call, "plain_ms": b_plain,
         "bound_ms": b_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None},
    ]
    return rows, line


class RenderReference:
    """The expected RGB of a /render request of image 2, from the source
    stack: the port's ``build_tables``, numpy projection and gathers."""

    def __init__(self, stack: np.ndarray):
        from omero_ms_pixel_buffer_tpu_torch.render import engine as rengine
        from omero_ms_pixel_buffer_tpu_torch.render.luts import LutRegistry

        self.stack, self.rengine, self.luts = stack, rengine, LutRegistry()
        self.tables = {}

    def rgb(self, query: dict, x: int, y: int, w: int, h: int) -> np.ndarray:
        from omero_ms_pixel_buffer_tpu_torch.render.masks import rasterize
        from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec

        spec = RenderSpec.from_params(query, default_channel=0)
        key = spec.signature()
        if key not in self.tables:
            self.tables[key] = self.rengine.build_tables(spec, np.dtype(np.uint16), self.luts)
        tables, luts = self.tables[key]
        chans = [ch.index for ch in spec.resolve_channels(self.stack.shape[0])]
        zs = [z for z, _ in spec.plane_range(0, 0, self.stack.shape[1], 1)]
        region = self.stack[chans][:, zs, y:y + h, x:x + w]
        if spec.projection == "intmax":
            planes = region.max(axis=1)
        elif spec.projection == "intmean":
            planes = (region.astype(np.int64).sum(axis=1) // len(zs)).astype(np.uint16)
        else:
            planes = region[:, 0]
        acc = np.zeros((h, w, 3), np.int64)
        for c in range(tables.shape[0]):
            acc += luts[c][tables[c][planes[c]]]
        rgb = np.minimum(acc, 255)
        if spec.masks:
            rgb = rgb * rasterize(spec.masks, x, y, w, h)[:, :, None]
        return rgb.astype(np.uint8)


def render_requests(rng, size: int, n: int, extra: str = ""):
    from urllib.parse import parse_qsl

    reqs = []
    for _ in range(n):
        x = int(rng.integers(0, (size - TILE) // 64 + 1)) * 64
        y = int(rng.integers(0, (size - TILE) // 64 + 1)) * 64
        query = f"c={RENDER_C}{extra}"
        reqs.append((f"/render/2/0/0/0?x={x}&y={y}&w={TILE}&h={TILE}&{query}&format=png",
                     (x, y, TILE, TILE), 200, dict(parse_qsl(query))))
    return reqs


def verify_render(results, reqs, ref: RenderReference) -> int:
    checked = 0
    for (status, body, _), (path, (x, y, w, h), want, query) in zip(results, reqs):
        require(status == want, f"{path} answered {status}, expected {want}")
        if status == 200:
            require(np.array_equal(decode_png(body), ref.rgb(query, x, y, w, h)),
                    f"{path}: pixels differ from the numpy composite")
            checked += 1
    return checked


def drive_render(registry: str, stack: np.ndarray, seed: int, n_requests: int,
                 device: str = "cuda") -> dict:
    """``path_render``: the /render plane on a server with the defaults."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    ref = RenderReference(stack)
    size = stack.shape[-1]
    rng = np.random.default_rng(seed + 5)
    checked = 0
    with ServerThread(registry, device=device) as client:
        reset_launch_counts()
        warm = render_requests(rng, size, 2 * LANES)
        t_warm = time.perf_counter()
        warm_out = []
        for k in range(2):
            warm_out += run_requests(client, warm[k * LANES:(k + 1) * LANES], LANES)[0]
        warm_s = time.perf_counter() - t_warm
        main = render_requests(rng, size, n_requests)
        before = get_json(client, "/healthz")
        main_out, main_s = run_requests(client, main, LANES)
        after = get_json(client, "/healthz")
        window = timed_window(before, after, main_s)
        groups = after["queue"]["composite_groups"] - before["queue"]["composite_groups"]
        window["composite_device_ms_per_group"] = (
            (after["queue"]["composite_device_ms_total"]
             - before["queue"]["composite_device_ms_total"]) / groups if groups else None)
        rounds = {}
        for name, extra in RENDER_ROUNDS:
            per_round = []
            for _ in range(2):
                reqs = render_requests(rng, size, LANES, extra)
                h0 = get_json(client, "/healthz")
                out, secs = run_requests(client, reqs, LANES)
                h1 = get_json(client, "/healthz")
                checked += verify_render(out, reqs, ref)
                per_round.append({
                    "seconds": secs,
                    "projection_host_pulls": (h1["render"]["projection_host_pulls"]
                                              - h0["render"]["projection_host_pulls"]),
                    "render_groups": (h1["queue"]["render_groups"]
                                      - h0["queue"]["render_groups"]),
                    "render_host_lanes": h1["render"]["host_lanes"] - h0["render"]["host_lanes"],
                    "supertile": supertile_delta(h0, h1)})
            rounds[name] = per_round
        # the second intmax round stays on the card: its independent lanes
        # crop resident planes on the device (no pull); super-tile groups
        # gather their bounding rectangle through the host, as the JAX
        # package does (their pulls are counted apart)
        second = rounds["intmax"][1]
        require(second["projection_host_pulls"] == second["supertile"]["host_pulls"]
                and second["render_groups"] + second["supertile"]["device_lanes"] > 0
                and second["render_host_lanes"] == 0,
                f"the second intmax round left the device: {rounds['intmax']}")
        pillow = True
        try:
            import PIL  # noqa: F401
        except ImportError:
            pillow = False
        from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import MAX_TILE_BYTES

        base = f"/render/2/0/0/0?x=0&y=0&w={TILE}&h={TILE}"
        # the whole stack of a full-plane projection: over the tile budget
        # at the default --render-size (4096: 402,653,184 bytes)
        over = stack.nbytes > MAX_TILE_BYTES
        edges = {
            "grammar_400": (f"{base}&c=1|9:1$FF0000", 400),
            "unknown_lut_400": (f"{base}&c=1$nope", 400),
            "channel_404": (f"{base}&c=9", 404),
            "stack_413": ("/render/2/0/0/0?w=0&h=0&c=1,2,3&p=intmax", 413 if over else 200),
            "jpeg": (f"{base}&c={RENDER_C}&format=jpeg", 200 if pillow else 404),
        }
        edge_status = {}
        for name, (path, want) in edges.items():
            status, body, _ = client.get(path)
            edge_status[name] = status
            require(status == want, f"{name}: {path} answered {status}, expected {want}")
            if name == "jpeg" and pillow:
                require(body[:2] == b"\xff\xd8", "the JPEG body is not a JPEG")
        launches = launch_counts()
        health = get_json(client, "/healthz")
    checked += verify_render(warm_out, warm, ref) + verify_render(main_out, main, ref)
    lat_ms = np.array([r[2] for r in main_out]) * 1e3
    require(launches["filter"] > 0 and launches["bitpack"] > 0,
            f"render: a kernel of the path never launched: {launches}")
    require(health["queue"]["failed"] == 0, f"encode groups failed: {health['queue']}")
    require(health["kernels"] == launches, "healthz counters disagree")
    return {
        "phase": "path_render", "tiles_verified": checked, "launches": launches,
        "requests": n_requests, "concurrency": LANES,
        "tiles_per_s": n_requests / main_s, "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)), "warmup_s": warm_s,
        "stream_bytes_mean": float(np.mean([png_stream_len(r[1]) for r in main_out])),
        "timed_window": window, "rounds": rounds, "edges": edge_status, "pillow": pillow,
        "render": health["render"], "queue": health["queue"],
        "plane_cache": health["plane_cache"], "batcher": health["batcher"],
        "result_cache": health["result_cache"], "gpu": health["gpu"],
    }


def drive_host_deflate(registry: str, data: np.ndarray, seed: int, n_requests: int = 32,
                       device: str = "cuda") -> dict:
    """``path_host_deflate``: /tile PNG lanes filtered on the card and
    deflated on the host (``device_deflate=False``)."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    with ServerThread(registry, device=device, device_deflate=False) as client:
        rng = np.random.default_rng(seed + 9)
        reset_launch_counts()
        reqs = tile_requests(rng, data.shape[0], n_requests)
        before = get_json(client, "/healthz")
        out, secs = run_requests(client, reqs, LANES)
        launches = launch_counts()
        health = get_json(client, "/healthz")
    checked = verify(out, reqs, data)
    require(launches["filter"] > 0, f"host deflate: the filter never launched: {launches}")
    require(launches["bitpack"] == 0 and launches["bitpack_dense"] == 0,
            f"host deflate: a packer launched: {launches}")
    require(health["queue"]["groups"] == 0, "host deflate: an encode group was queued")
    return {"phase": "path_host_deflate", "tiles_verified": checked, "launches": launches,
            "requests": n_requests, "seconds": secs,
            "host_deflate_lanes": health["host_deflate_lanes"] - before["host_deflate_lanes"],
            "lone_lanes": health["batcher"]["lone"] - before["batcher"]["lone"],
            "host_engine": health["host_engine"], "device_deflate": health["device_deflate"]}


# ---------------------------------------------------------------------------
# the histogram plane and super-tile fusion
# ---------------------------------------------------------------------------

HIST_BINS = (256, 65536)


def histogram_requests(rng, stack: np.ndarray, n: int):
    """``n`` 512x512 region histograms of channels 1-3 at random z, bins
    256 and 65536 in turn, plus 8 full-plane ones (w = h = 0), shuffled:
    [(path, (z, x, y, w, h, bins))]."""
    depth, size = stack.shape[1], stack.shape[-1]
    reqs = []
    for k in range(n):
        x = int(rng.integers(0, (size - TILE) // 64 + 1)) * 64
        y = int(rng.integers(0, (size - TILE) // 64 + 1)) * 64
        z, bins = int(rng.integers(0, depth)), HIST_BINS[k % 2]
        reqs.append((f"/histogram/2/{z}/0/0?x={x}&y={y}&w={TILE}&h={TILE}&c=1,2,3"
                     f"&bins={bins}&usePixelsTypeRange=1", (z, x, y, TILE, TILE, bins)))
    for k in range(8):
        z, bins = k % depth, HIST_BINS[k * len(HIST_BINS) // 8]
        reqs.append((f"/histogram/2/{z}/0/0?w=0&h=0&c=1,2,3&bins={bins}&usePixelsTypeRange=1",
                     (z, 0, 0, size, size, bins)))
    return [reqs[i] for i in rng.permutation(len(reqs))]


def verify_histogram(body: bytes, stack: np.ndarray, spec) -> None:
    """The body's counts against ``np.bincount`` of the source region over
    the uint16 range (``usePixelsTypeRange``), channel by channel."""
    z, x, y, w, h, bins = spec
    doc = json.loads(body)
    require(doc["region"] == [x, y, w, h] and doc["bins"] == bins
            and [ch["index"] for ch in doc["channels"]] == [0, 1, 2],
            f"histogram body header: {doc['region']} {doc['bins']}")
    for c, ch in enumerate(doc["channels"]):
        v = stack[c, z, y:y + h, x:x + w].astype(np.float64)
        idx = np.minimum(np.floor(v / 65535.0 * bins), bins - 1).astype(np.int64)
        want = np.bincount(idx.ravel(), minlength=bins)
        require(ch["counts"] == want.tolist() and ch["stats"]["count"] == w * h,
                f"histogram z={z} c={c} ({x},{y},{w},{h}) bins={bins}: counts differ")
    require(doc["data"] == doc["channels"][0]["counts"], "histogram data != first channel")


def histogram_program(stack: np.ndarray, lanes: int = 8) -> dict:
    """The torch histogram alone on the card at a serving group's shape
    (``lanes`` 512x512 channel regions of image 2), per bins value: device
    ms of one call (every kernel and memset it issues), its top kernels,
    its byte bound (planes and tables read once, counts written once), and
    beside it the same counts through one ``torch.bincount`` (checked
    equal), the formulation the port does not use."""
    import torch

    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
    from omero_ms_pixel_buffer_tpu_torch.render.analysis import build_bin_table, histogram_torch

    planes = np.stack([stack[k % 3, k % stack.shape[1], :TILE, k * 64:k * 64 + TILE]
                       for k in range(lanes)])
    dev = bits_tensor(planes).to("cuda")
    out = {}
    for bins in HIST_BINS:
        tabs = np.stack([build_bin_table(np.dtype(np.uint16), (0.0, 65535.0), bins)] * lanes)
        tabs_dev = torch.from_numpy(tabs).to("cuda")
        call = lambda: histogram_torch(dev, tabs_dev, bins)  # noqa: E731
        offsets = torch.arange(lanes, device="cuda", dtype=torch.int64)[:, None] * bins

        def bincount():
            idx = dev.reshape(lanes, -1).to(torch.int64) & 0xFFFF
            binned = torch.gather(tabs_dev.to(torch.int64), 1, idx) + offsets
            return torch.bincount(binned.reshape(-1), minlength=lanes * bins)

        require(torch.equal(bincount().reshape(lanes, bins).to(torch.int32), call()),
                f"histogram_torch != bincount at bins={bins}")
        nbytes = planes.nbytes + tabs.nbytes + lanes * bins * 4
        out[str(bins)] = {"lanes": lanes, "device_ms": call_device_ms(torch, call),
                          "bincount_device_ms": call_device_ms(torch, bincount),
                          "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                          "by_kernel": device_breakdown(torch, call, top=6, iters=10)}
    return out


def drive_histogram(registry: str, stack: np.ndarray, seed: int, n_requests: int,
                    device: str = "cuda") -> dict:
    """``path_histogram``: /histogram on a server with the defaults."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    reqs = histogram_requests(np.random.default_rng(seed + 11), stack, n_requests)
    with ServerThread(registry, device=device) as client:
        reset_launch_counts()
        before = get_json(client, "/healthz")
        with concurrent.futures.ThreadPoolExecutor(LANES) as pool:
            t0 = time.perf_counter()
            out = list(pool.map(lambda r: client.request("GET", r[0]), reqs))
            secs = time.perf_counter() - t0
        after = get_json(client, "/healthz")
        launches = launch_counts()
    misses = 0
    for (status, hdrs, body, _), (path, spec) in zip(out, reqs):
        require(status == 200, f"{path} answered {status}")
        verify_histogram(body, stack, spec)
        misses += hdrs.get("X-Cache") == "miss"
    a0, a1 = before["analysis"], after["analysis"]
    groups = a1["device_groups"] - a0["device_groups"]
    timed = a1["timed_groups"] - a0["timed_groups"]
    lanes = a1["device_lanes"] - a0["device_lanes"]
    require(a1["device"].startswith("cuda") and lanes == 3 * misses and a1["failed_groups"] == 0,
            f"histogram lanes reduced off the card: {a1}, {misses} misses")
    device_ms = (a1["device_ms_total"] - a0["device_ms_total"]) / timed if timed else None
    nbytes = (a1["device_bytes_total"] - a0["device_bytes_total"]) / timed if timed else None
    lat_ms = np.array([r[3] for r in out]) * 1e3
    return {
        "phase": "path_histogram", "requests": len(reqs), "concurrency": LANES,
        "bodies_verified": len(out), "misses": misses,
        "tiles_per_s": len(reqs) / secs, "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)), "seconds": secs,
        "device_groups": groups, "device_lanes": lanes,
        "lanes_reduced_elsewhere": 3 * misses - lanes,
        "device_ms_per_group": device_ms, "bytes_per_group": nbytes,
        "bound_ms_per_group": nbytes / HBM_BYTES_PER_S * 1e3 if nbytes else None,
        "bound_by": "bytes", "launches": launches, "analysis": a1,
        "program": histogram_program(stack) if device == "cuda" else None,
        "batcher": after["batcher"], "gpu": after["gpu"],
    }


def viewport_requests(rng, size: int, n: int):
    """``n`` 4x4 viewports of 512x512 tiles at random origins on the 512
    grid, the last at the image's edge (origin size - 1792: its last
    column and row are 256 wide). Each viewport has its own channel
    windows, so no tile repeats one of another viewport."""
    span = 4 * TILE
    origins = [(int(rng.integers(0, (size - span) // TILE + 1)) * TILE,
                int(rng.integers(0, (size - span) // TILE + 1)) * TILE) for _ in range(n - 1)]
    origins.append((size - span + TILE // 2, size - span + TILE // 2))
    from urllib.parse import parse_qsl

    views = []
    for k, (x0, y0) in enumerate(origins):
        query = (f"c=1|{500 + k}:30000$FF0000,2|1000:{40000 + k}$00FF00,"
                 f"3|0:65535$0000FF")
        reqs = []
        for r in range(4):
            for c in range(4):
                x, y = x0 + c * TILE, y0 + r * TILE
                w, h = min(TILE, size - x), min(TILE, size - y)
                reqs.append((f"/render/2/0/0/0?x={x}&y={y}&w={w}&h={h}&{query}&format=png",
                             (x, y, w, h), 200, dict(parse_qsl(query))))
        views.append(reqs)
    return views


def composite_carve_program(stack: np.ndarray) -> dict:
    """The torch composite + carve alone on the card at a viewport's shape
    (a (3, 2048, 2048) stack of image 2 carved into sixteen 512x512
    buckets): device ms of one call, its top kernels and its byte bound
    (stack and packed tables read once, carved batch written once)."""
    import torch

    from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
    from omero_ms_pixel_buffer_tpu_torch.render import engine as rengine
    from omero_ms_pixel_buffer_tpu_torch.render.luts import LutRegistry
    from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
    from omero_ms_pixel_buffer_tpu_torch.render.supertile import composite_carve_torch

    span = 4 * TILE
    planes = np.ascontiguousarray(stack[:, 0, :span, :span])
    tables, luts = rengine.build_tables(RenderSpec.from_params({"c": RENDER_C}),
                                        np.dtype(np.uint16), LutRegistry())
    packed = rengine.packed_rgb_tables(tables, luts)
    packed_dev = torch.from_numpy(packed).to("cuda")
    dev = bits_tensor(planes).to("cuda")
    coords = [(y, x) for y in range(0, span, TILE) for x in range(0, span, TILE)]
    call = lambda: composite_carve_torch(dev, tables, luts, coords, TILE, TILE,  # noqa: E731
                                         packed=packed_dev)
    nbytes = planes.nbytes + packed.nbytes + len(coords) * TILE * TILE * 3
    return {"stack": list(planes.shape), "lanes": len(coords),
            "device_ms": call_device_ms(torch, call),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "by_kernel": device_breakdown(torch, call, top=8)}


def drive_supertile(registry: str, stack: np.ndarray, seed: int, n_views: int,
                    enabled: bool = True, device: str = "cuda", run: int = 1) -> dict:
    """``path_supertile`` (``enabled``) or ``path_supertile_off``: the
    viewports of ``viewport_requests`` one after another on a fresh
    server, the 16 requests of each at once, every tile checked against
    the numpy composite. The composite + carve alone is timed in the
    first fused run."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    ref = RenderReference(stack)
    views = viewport_requests(np.random.default_rng(seed + 13), stack.shape[-1], n_views)
    out, secs = [], 0.0
    with ServerThread(registry, device=device, supertile_enabled=enabled) as client:
        reset_launch_counts()
        before = get_json(client, "/healthz")
        for reqs in views:
            got, s = run_requests(client, reqs, len(reqs))
            out.append(got)
            secs += s
        after = get_json(client, "/healthz")
        launches = launch_counts()
    checked = sum(verify_render(got, reqs, ref) for got, reqs in zip(out, views))
    st0, st1 = before["supertile"], after["supertile"]
    st = supertile_delta(before, after)
    timed = st1["composite_carve_groups"] - st0["composite_carve_groups"]
    device_ms = ((st1["composite_carve_device_ms_total"] - st0["composite_carve_device_ms_total"])
                 / timed if timed else None)
    nbytes = ((st1["composite_carve_bytes_total"] - st0["composite_carve_bytes_total"]) / timed
              if timed else None)
    lat_ms = np.array([r[2] for got in out for r in got]) * 1e3
    require(after["queue"]["failed"] == 0, f"encode groups failed: {after['queue']}")
    if enabled:
        require(st["device_lanes"] > 0, f"no lane was fused on the card: {st}")
        require(launches["filter"] > 0 and launches["bitpack"] > 0,
                f"supertile: a kernel of the path never launched: {launches}")
    else:
        require(st["stamped_lanes"] == 0 and st["groups"] == 0, f"fusion off but fused: {st}")
    q0, q1 = before["queue"], after["queue"]
    return {
        "phase": "path_supertile" if enabled else "path_supertile_off", "run": run,
        "viewports": len(views), "tiles_verified": checked, "requests": checked,
        "tiles_per_s": checked / secs, "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)), "seconds": secs,
        "supertile": st,
        "mean_lanes_per_group": st["device_lanes"] / st["groups"] if st["groups"] else None,
        "composite_carve_device_ms_per_group": device_ms, "bytes_per_group": nbytes,
        "bound_ms_per_group": nbytes / HBM_BYTES_PER_S * 1e3 if nbytes else None,
        "bound_by": "bytes", "launches": launches,
        "encode_groups": q1["groups"] - q0["groups"],
        "render_groups": q1["render_groups"] - q0["render_groups"],
        "render_host_lanes": after["render"]["host_lanes"] - before["render"]["host_lanes"],
        "projection_host_pulls": (after["render"]["projection_host_pulls"]
                                  - before["render"]["projection_host_pulls"]),
        "plane_cache": after["plane_cache"], "batcher": after["batcher"], "gpu": after["gpu"],
        "program": (composite_carve_program(stack)
                    if enabled and run == 1 and device == "cuda" else None),
    }


def supertile_pair(registry: str, stack: np.ndarray, seed: int, n_views: int) -> dict:
    """``path_supertile`` and ``path_supertile_off`` twice each, in the
    order off, on, on, off, each emitted; returns both settings' tiles/s,
    p50 and p99 side by side."""
    runs = []
    for run, enabled in ((1, False), (1, True), (2, True), (2, False)):
        out = drive_supertile(registry, stack, seed, n_views, enabled=enabled, run=run)
        emit(out)
        runs.append(out)

    def side(enabled):
        return {k: [r[k] for r in runs if (r["phase"] == "path_supertile") is enabled]
                for k in ("tiles_per_s", "p50_ms", "p99_ms", "encode_groups")}

    fused, unfused = side(True), side(False)
    return {"phase": "supertile_pair", "order": "off, on, on, off",
            "fused": fused, "unfused": unfused,
            # adjacent runs: (off 1, on 1) and (on 2, off 2)
            "tiles_per_s_ratio": [f / u for f, u in
                                  zip(fused["tiles_per_s"], unfused["tiles_per_s"])]}


# ---------------------------------------------------------------------------
# the whole-slide JPEG RGB pyramid, the device IDCT, the TIFF layouts
# ---------------------------------------------------------------------------

WSI_TILE = 256
# the small layout fixtures of ``path_layouts``: registry id -> (name,
# writer keywords); each a 1024x1024 plane (C = 3 for the float image),
# but LZW's 512x512 (the writer's Python LZW encoder takes ~40 s a MB)
LAYOUT_SIZE = 1024
LAYOUTS = {
    10: ("lzw_u16", dict(compression="lzw")),
    11: ("packbits_u8", dict(compression="packbits")),
    12: ("zstd_u16", dict(compression="zstd")),
    13: ("zlib_pred2_u16", dict(compression="zlib", predictor=2)),
    14: ("zlib_strips_u16", dict(compression="zlib", tile_size=None)),
    15: ("bigtiff_le_u16", dict(compression="zlib", bigtiff=True, big_endian=False)),
    16: ("zlib_f32_c3", dict(compression="zlib")),
}
ROMIO_ID = 17
F32_ID = 16
F32_C = "1|-1500:2500$FF0000,2|0:3000$00FF00,3|-800:800$0000FF"


def make_wsi(size: int, seed: int) -> np.ndarray:
    """A stained-tissue-like (size, size, 3) uint8 slide: smooth colour
    fields with structure at several scales plus noise, from ``seed``,
    made a band of rows at a time."""
    rng = np.random.default_rng(seed + 11)
    out = np.empty((size, size, 3), np.uint8)
    xx = np.arange(size, dtype=np.float32)[None, :]
    for y0 in range(0, size, 1024):
        yy = np.arange(y0, min(size, y0 + 1024), dtype=np.float32)[:, None]
        tissue = (np.sin(xx / 211.0) * np.cos(yy / 157.0)
                  + 0.5 * np.sin((xx + yy) / 53.0) + 0.25 * np.cos(xx / 9.0 - yy / 13.0))
        for c, (base, amp) in enumerate(((200.0, 60.0), (150.0, 80.0), (190.0, 50.0))):
            noise = rng.standard_normal((yy.shape[0], size), dtype=np.float32) * 6.0
            out[y0:y0 + yy.shape[0], :, c] = (base - amp * tissue + noise).clip(0, 255)
    return out


def wsi_levels(size: int) -> int:
    """Pyramid levels from ``size`` down to the first at or under 1024."""
    levels = 1
    while size > 1024:
        size = (size + 1) // 2
        levels += 1
    return levels


def _raw_zstd_frame(data: bytes) -> bytes:
    """A valid zstd frame (RFC 8878) of raw blocks: magic, a single-
    segment header with a 4-byte content size, then blocks of at most
    128 KiB stored as they are. Lets the smoke write a zstd TIFF where
    the ``zstandard`` package is missing."""
    out = bytearray(struct.pack("<IB", 0xFD2FB528, (2 << 6) | (1 << 5)))
    out += struct.pack("<I", len(data))
    blocks = [data[i:i + 131072] for i in range(0, len(data), 131072)] or [b""]
    for k, block in enumerate(blocks):
        out += struct.pack("<I", (k == len(blocks) - 1) | (len(block) << 3))[:3] + block
    return bytes(out)


class _RawZstd:
    """Stands in for ``zstandard`` while the writer runs without it."""

    class ZstdCompressor:
        def __init__(self, level=3):
            pass

        @staticmethod
        def compress(raw: bytes) -> bytes:
            return _raw_zstd_frame(raw)


def layout_data(seed: int) -> dict:
    """The source arrays of ``path_layouts``: registry id -> TCZYX data."""
    rng = np.random.default_rng(seed + 13)
    yy, xx = np.mgrid[0:LAYOUT_SIZE, 0:LAYOUT_SIZE].astype(np.float32)
    field = 2000 + 1500 * np.sin(xx / 71.0) * np.cos(yy / 89.0)
    out = {}
    for rid in (10, 12, 13, 14, 15, ROMIO_ID):
        u16 = (field + rng.normal(0, 80, field.shape)).clip(0, 65535).astype(np.uint16)
        out[rid] = u16[None, None, None]
    out[11] = ((field / 16) + rng.normal(0, 3, field.shape)).clip(0, 255).astype(np.uint8)[
        None, None, None]
    out[10] = out[10][..., :512, :512].copy()
    out[ROMIO_ID] = np.stack([out[ROMIO_ID][0, 0], out[13][0, 0]])[None]  # C = 2
    out[F32_ID] = np.stack([(field - 2000) * (c + 1) / 2 + rng.normal(0, 50, field.shape)
                            for c in range(3)]).astype(np.float32)[None, :, None]
    return out


def write_wsi_fixtures(wsi: np.ndarray, layouts: dict) -> tuple:
    """Image 3 (the JPEG RGB pyramid), the layout fixtures and a ROMIO
    plane file, with their registry: (registry path, image 3 path, zstd
    written with the real codec or not)."""
    from omero_ms_pixel_buffer_tpu_torch.io.ometiff import write_ome_tiff
    from omero_ms_pixel_buffer_tpu_torch.io.romio import write_romio

    os.makedirs(WORK, exist_ok=True)
    wsi_path = os.path.join(WORK, "wsi.tif")
    write_ome_tiff(wsi_path, wsi[None, None, None], tile_size=(WSI_TILE, WSI_TILE),
                   pyramid_levels=wsi_levels(wsi.shape[0]), compression="jpeg",
                   jpeg_quality=85, jpeg_subsampling=2, ome_xml=False)
    images = [{"id": 3, "path": wsi_path, "name": "wsi"}]
    try:
        import zstandard  # noqa: F401
        real_zstd = True
    except ImportError:
        real_zstd = False
    for rid, (name, kw) in LAYOUTS.items():
        path = os.path.join(WORK, f"{name}.ome.tif")
        kw = {"tile_size": (WSI_TILE, WSI_TILE), **kw}
        if kw["compression"] == "zstd" and not real_zstd:
            missing = "zstandard" not in sys.modules
            held = sys.modules.get("zstandard")
            sys.modules["zstandard"] = _RawZstd
            try:
                write_ome_tiff(path, layouts[rid], **kw)
            finally:
                if missing:
                    del sys.modules["zstandard"]
                else:
                    sys.modules["zstandard"] = held
        else:
            write_ome_tiff(path, layouts[rid], **kw)
        images.append({"id": rid, "path": path, "name": name})
    romio = os.path.join(WORK, "Pixels", str(ROMIO_ID))
    os.makedirs(os.path.dirname(romio), exist_ok=True)
    write_romio(romio, layouts[ROMIO_ID])
    images.append({"id": ROMIO_ID, "path": romio, "type": "romio", "sizeX": LAYOUT_SIZE,
                   "sizeY": LAYOUT_SIZE, "sizeZ": 1, "sizeC": 2, "sizeT": 1,
                   "pixelsType": "uint16"})
    registry = os.path.join(WORK, "registry_wsi.json")
    with open(registry, "w") as f:
        json.dump({"images": images}, f)
    return registry, wsi_path, real_zstd


class HostDecode:
    """The port's host decode (islow IDCT) of image 3's regions: the
    reference every ``/tile`` body of the WSI phases is held against."""

    def __init__(self, path: str):
        from omero_ms_pixel_buffer_tpu_torch.io.ometiff import OmeTiffPixelBuffer

        self.buf = OmeTiffPixelBuffer(path)

    def region(self, level, x, y, w, h) -> np.ndarray:
        saved = os.environ.pop("OMPB_JPEG_DEVICE_IDCT", None)
        try:
            return self.buf.get_tile_at(level, 0, 0, 0, x, y, w, h)
        finally:
            if saved is not None:
                os.environ["OMPB_JPEG_DEVICE_IDCT"] = saved

    def pillow_tile(self, x, y) -> np.ndarray:
        """Pillow's decode of the level-0 JPEG tile at (x, y): its stream
        with the tag-347 tables spliced in, an independent oracle of
        ``region`` on the grid."""
        from PIL import Image

        ifd = self.buf.ifds[0]
        i = (y // WSI_TILE) * (self.buf.level_size(0)[0] // WSI_TILE) + x // WSI_TILE
        off, cnt = ifd.values("TILE_OFFSETS")[i], ifd.values("TILE_COUNTS")[i]
        stream = ifd.values("JPEG_TABLES")[0][:-2] + bytes(self.buf.mm[off + 2: off + cnt])
        return np.asarray(Image.open(io.BytesIO(stream)).convert("RGB"))

    def close(self) -> None:
        self.buf.close()


def wsi_requests(ref: HostDecode, seed: int, n: int, levels=(0, 1)):
    """A DeepZoom-style raster sweep: per level, rows of 16 adjacent 256x256
    tiles from a seeded origin on the tile grid, ``n`` in all."""
    rng = np.random.default_rng(seed + 17)
    reqs = []
    per_level = [n // len(levels) + (k < n % len(levels)) for k in range(len(levels))]
    for level, count in zip(levels, per_level):
        w, h = ref.buf.level_size(level)
        cols, rows = w // WSI_TILE, h // WSI_TILE
        span = min(16, cols)
        need_rows = -(-count // span)
        c0 = int(rng.integers(0, cols - span + 1))
        r0 = int(rng.integers(0, max(1, rows - need_rows + 1)))
        for k in range(count):
            x = (c0 + k % span) * WSI_TILE
            y = ((r0 + k // span) % rows) * WSI_TILE
            reqs.append((f"/tile/3/0/0/0?x={x}&y={y}&w={WSI_TILE}&h={WSI_TILE}"
                         f"&format=png&resolution={level}", (level, x, y, WSI_TILE, WSI_TILE),
                         200))
    return reqs


def wsi_tiles(ref: HostDecode, seed: int, n: int = LANES) -> np.ndarray:
    """``n`` host-decoded 256x256 RGB tiles of level 0 at seeded grid spots."""
    rng = np.random.default_rng(seed + 19)
    w, h = ref.buf.level_size(0)
    spots = rng.integers(0, [w // WSI_TILE, h // WSI_TILE], (n, 2)) * WSI_TILE
    return np.stack([ref.region(0, int(x), int(y), WSI_TILE, WSI_TILE) for x, y in spots])


def check_wsi_kernels(torch, device, tiles: np.ndarray):
    """The filter (bpp 3) and the scalar-prefetch packer at the WSI shape:
    32 RGB8 lanes of 256x256 from image 3, and the packer on their real
    ``dynamic`` pass-2 tokens, each byte-equal to its plain version (every
    lane's stream inflates back). Returns the kernel rows."""
    from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as dd
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.bitpack import (
        pack_tokens_sp,
        pack_tokens_sp_plain,
    )
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels.filter import (
        filter_tiles,
        filter_tiles_plain,
    )

    rgb = torch.from_numpy(tiles).to(device)
    got, want = filter_tiles(rgb, "up"), filter_tiles_plain(rgb, "up")
    torch.cuda.synchronize()
    f_err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
    require(torch.equal(got, want), "filter kernel != plain on WSI RGB lanes")
    f_call = time_ms(torch, lambda: filter_tiles(rgb, "up"))
    f_ms = kernel_ms(torch, lambda: filter_tiles(rgb, "up"), "filter_row_groups")
    f_plain = time_ms(torch, lambda: filter_tiles_plain(rgb, "up"))
    f_bytes = rgb.numel() + got.numel()
    row_bytes = 1 + WSI_TILE * 3
    flat, counts, extras, real = dd.fused_filter_histogram_batch(rgb, WSI_TILE, row_bytes, 3)
    tables = dd.build_dynamic_tables(counts.cpu().numpy(), extras.cpu().numpy(), real=real)
    bits, nbits = dd.emit_tokens(flat, dd.tables_from_numpy(tables, device))
    maxbits = dd._packing_maxbits(flat.shape[1])
    got_p, got_t = pack_tokens_sp(bits, nbits, maxbits)
    want_p, want_t = pack_tokens_sp_plain(bits, nbits, maxbits)
    torch.cuda.synchronize()
    b_err = int((got_p.to(torch.int64) - want_p.to(torch.int64)).abs().max().item())
    require(torch.equal(got_p, want_p) and torch.equal(got_t, want_t),
            "bitpack kernel != plain on WSI pass-2 tokens")
    streams, lengths = dd._frame_lanes(flat, got_p, got_t, eob_bits=0)
    streams_np, lengths_np, flat_np = (streams.cpu().numpy(), lengths.cpu().numpy(),
                                       flat.cpu().numpy())
    for i in range(real):
        require(zlib.decompress(streams_np[i, : lengths_np[i]].tobytes())
                == flat_np[i].tobytes(), f"WSI lane {i} dynamic stream does not inflate back")
    call = lambda: pack_tokens_sp(bits, nbits, maxbits)  # noqa: E731
    b_call = time_ms(torch, call)
    b_ms = call_device_ms(torch, call)
    b_plain = time_ms(torch, lambda: pack_tokens_sp_plain(bits, nbits, maxbits), iters=5)
    b_bytes = 8 * bits.numel() + bits.shape[0] * maxbits // 8
    return [
        {"name": "filter_wsi_rgb8", "route": "cuda",
         "source": "omero_ms_pixel_buffer_tpu_torch/csrc/filter.cu",
         "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/filter.py:137",
         "shape": list(rgb.shape), "max_abs_err": f_err, "ms": f_ms if f_ms else f_call,
         "ms_from": "profiler" if f_ms else "events", "call_ms": f_call, "plain_ms": f_plain,
         "bound_ms": f_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None},
        {"name": "bitpack_wsi", "route": "cuda",
         "source": "omero_ms_pixel_buffer_tpu_torch/csrc/bitpack.cu",
         "replaces": "omero_ms_pixel_buffer_tpu/ops/pallas/bitpack.py:201",
         "shape": list(bits.shape), "max_abs_err": b_err, "ms": b_ms if b_ms else b_call,
         "ms_from": "profiler" if b_ms else "events", "call_ms": b_call, "plain_ms": b_plain,
         "bound_ms": b_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
         "stream_bytes_mean": float(lengths_np[:real].mean())},
    ]


def idct_f64(coefs: np.ndarray, q: np.ndarray) -> np.ndarray:
    """The float IDCT in float64 numpy: the reference of the card's."""
    from omero_ms_pixel_buffer_tpu_torch.io.jpeg import _A

    deq = (coefs.astype(np.int64) * q[None, :]).astype(np.float64).reshape(-1, 8, 8)
    basis = _A.astype(np.float64)
    s = np.einsum("uy,nuv,vx->nyx", basis, deq, basis)
    return np.clip(np.round(s) + 128.0, 0, 255).astype(np.uint8)


def check_idct(torch, device, wsi_path: str, seed: int, n_tiles: int = 10) -> dict:
    """``idct``: ``idct_blocks_torch`` on the card against its CPU version
    and the float64 numpy IDCT on every coefficient block of ``n_tiles``
    JPEG tiles of image 3 (caught from the host decode), equal with TF32
    allowed and not; its device time at N = 1024 blocks beside the byte
    bound ((N, 64) int32 in, (N, 64) uint8 out)."""
    from omero_ms_pixel_buffer_tpu_torch.io import jpeg as pj
    from omero_ms_pixel_buffer_tpu_torch.io.ometiff import OmeTiffPixelBuffer

    buf = OmeTiffPixelBuffer(wsi_path)
    try:
        ifd = buf.ifds[0]
        tables = pj.parse_tables(ifd.values("JPEG_TABLES")[0])
        offs, cnts = ifd.values("TILE_OFFSETS"), ifd.values("TILE_COUNTS")
        picks = np.random.default_rng(seed + 23).choice(len(offs), n_tiles, replace=False)
        caught = []
        host_idct = pj.idct_blocks_host

        def grab(c, q):
            caught.append((c.copy(), q.copy()))
            return host_idct(c, q)

        pj.idct_blocks_host = grab
        try:
            for i in picks:
                pj.decode_jpeg(bytes(buf.mm[offs[i]: offs[i] + cnts[i]]), tables=tables,
                               idct_mode="host")
        finally:
            pj.idct_blocks_host = host_idct
    finally:
        buf.close()
    err_f64 = err_cpu = 0
    blocks = 0
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        for coefs, q in caught:
            torch.backends.cuda.matmul.allow_tf32 = False
            off = pj.idct_blocks_torch(coefs, q, device).cpu().numpy()
            torch.backends.cuda.matmul.allow_tf32 = True
            on = pj.idct_blocks_torch(coefs, q, device).cpu().numpy()
            require(np.array_equal(on, off), "device IDCT moved with allow_tf32")
            cpu = pj.idct_blocks_torch(coefs, q, "cpu").numpy()
            err_f64 = max(err_f64, int(np.abs(off.astype(int) - idct_f64(coefs, q)).max()))
            err_cpu = max(err_cpu, int(np.abs(off.astype(int) - cpu.astype(int)).max()))
            blocks += coefs.shape[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    require(err_f64 <= 1, f"device IDCT {err_f64} counts from float64")
    require(err_cpu <= 1, f"device IDCT {err_cpu} counts from its CPU version")
    luma = np.concatenate([c for c, _ in caught[::3]])[:1024]
    c_dev = torch.from_numpy(luma).to(device)
    q_dev = torch.from_numpy(caught[0][1]).to(device)
    call = lambda: pj.idct_blocks_torch(c_dev, q_dev, device)  # noqa: E731
    nbytes = luma.shape[0] * 64 * 4 + luma.shape[0] * 64
    return {"phase": "idct", "tiles": n_tiles, "blocks": blocks,
            "max_abs_err_vs_float64": err_f64, "max_abs_err_vs_cpu": err_cpu,
            "tf32_independent": True, "allow_tf32_flag": flag,
            "n_blocks_timed": int(luma.shape[0]),
            "ms": call_device_ms(torch, call), "call_ms": time_ms(torch, call),
            "cpu_ms": _host_ms(lambda: pj.idct_blocks_torch(luma, caught[0][1], "cpu")),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "by_kernel": device_breakdown(torch, call, iters=10)}


def _host_ms(fn, iters: int = 5) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def reads_delta(before: dict, after: dict, seconds: float) -> dict:
    """The batched host reads between two ``/healthz`` views: the read
    stage's milliseconds, their share of the ``handle_batch`` time they
    sit in, and thread-seconds of reading per wall second."""
    b, a = before["reads"], after["reads"]
    read_ms = a["ms_total"] - b["ms_total"]
    batch_ms = a["batch_ms_total"] - b["batch_ms_total"]
    lanes = a["lanes"] - b["lanes"]
    return {"calls": a["calls"] - b["calls"], "lanes": lanes, "read_ms": read_ms,
            "read_ms_per_lane": read_ms / lanes if lanes else None,
            "batch_ms": batch_ms, "read_share_of_batch": read_ms / batch_ms if batch_ms else None,
            "read_busy_share": read_ms / 1e3 / seconds,
            "rgb_device_lanes": a["rgb_device_lanes"] - b["rgb_device_lanes"]}


def drive_wsi(registry: str, ref: HostDecode, seed: int, n_requests: int,
              device_idct: bool = False, device: str = "cuda") -> dict:
    """``path_wsi`` (or ``path_wsi_device_idct``): a server with the
    defaults (``OMPB_JPEG_DEVICE_IDCT=1`` for the second); 32 warm-up
    tiles of level 2, then ``n_requests`` 256x256 PNG tiles of a raster
    sweep over levels 0 and 1 at concurrency 32, timed. Every body is
    decoded (colour type 2) and held against the port's host decode:
    equal, or within 3 with the device IDCT (its pixels that differ are
    counted; the JAX device mode is 3 from its host mode on RGB streams).
    The host decode of every level-0 tile is held against Pillow's."""
    from omero_ms_pixel_buffer_tpu_torch.ops.kernels import (
        launch_counts,
        reset_launch_counts,
    )

    phase = "path_wsi_device_idct" if device_idct else "path_wsi"
    saved = os.environ.get("OMPB_JPEG_DEVICE_IDCT")
    os.environ["OMPB_JPEG_DEVICE_IDCT"] = "1" if device_idct else "0"
    try:
        with ServerThread(registry, device=device) as client:
            reset_launch_counts()
            warm = wsi_requests(ref, seed + 1, LANES,
                                levels=(min(2, ref.buf.resolution_levels - 1),))
            warm_out = run_requests(client, warm, LANES)[0]
            reqs = wsi_requests(ref, seed + (7 if device_idct else 0), n_requests)
            before = get_json(client, "/healthz")
            out, seconds = run_requests(client, reqs, LANES)
            after = get_json(client, "/healthz")
            launches = launch_counts()
    finally:
        if saved is None:
            os.environ.pop("OMPB_JPEG_DEVICE_IDCT", None)
        else:
            os.environ["OMPB_JPEG_DEVICE_IDCT"] = saved
    max_diff, diff_px, checked, pillow_checked = 0, 0, 0, 0
    for (status, body, _), (path, (level, x, y, w, h), want) in zip(warm_out + out, warm + reqs):
        require(status == want, f"{path} answered {status}, expected {want}")
        got = decode_png(body)
        expect = ref.region(level, x, y, w, h)
        require(got.shape == expect.shape == (h, w, 3), f"{path}: not an RGB tile")
        if level == 0:
            require(np.array_equal(expect, ref.pillow_tile(x, y)),
                    f"{path}: the host decode differs from Pillow's")
            pillow_checked += 1
        d = np.abs(got.astype(int) - expect.astype(int))
        max_diff, diff_px = max(max_diff, int(d.max())), diff_px + int((d > 0).sum())
        checked += 1
    if device_idct:
        require(max_diff <= 3, f"{phase}: {max_diff} counts from the host decode")
    else:
        require(max_diff == 0, f"{phase}: pixels differ from the host decode")
    lat_ms = np.array([r[2] for r in out]) * 1e3
    require(pillow_checked > 0, f"{phase}: no level-0 tile held against Pillow")
    require(launches["filter"] > 0 and launches["bitpack"] > 0,
            f"{phase}: the filter or the SP packer never launched: {launches}")
    reads = reads_delta(before, after, seconds)
    require(reads["rgb_device_lanes"] > 0, f"{phase}: no RGB lane went to the device")
    require(after["queue"]["failed"] == 0, f"{phase}: encode groups failed: {after['queue']}")
    jb, ja = before["jpeg"], after["jpeg"]
    calls = ja["device_idct_calls"] - jb["device_idct_calls"]
    if device_idct:
        require(calls > 0 and ja["device_idct_failed"] == 0,
                f"{phase}: device IDCT calls {calls}, failed {ja['device_idct_failed']}")
    else:
        require(ja["device_idct_calls"] == 0, f"{phase}: device IDCT ran in host mode")
    timed = ja["device_idct_timed_calls"] - jb["device_idct_timed_calls"]
    return {
        "phase": phase, "requests": n_requests, "concurrency": LANES,
        "tiles_verified": checked, "host_tiles_equal_to_pillow": pillow_checked,
        "max_abs_diff_vs_host": max_diff,
        "pixels_differing": diff_px, "launches": launches,
        "tiles_per_s": n_requests / seconds, "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "stream_bytes_mean": float(np.mean([png_stream_len(r[1]) for r in out])),
        "timed_window": timed_window(before, after, seconds), "reads": reads,
        "jpeg": {"device_idct_calls": calls,
                 "device_idct_blocks": ja["device_idct_blocks"] - jb["device_idct_blocks"],
                 # CUDA-event span on the IDCT stream: concurrent readers
                 # and GIL waits inflate it over the device time alone
                 "span_ms_per_call": ((ja["device_idct_span_ms_total"]
                                       - jb["device_idct_span_ms_total"]) / timed
                                      if timed else None)},
        "queue": after["queue"], "gpu": after["gpu"],
    }


def _layout_requests(rid: int, data: np.ndarray, c: int = 0):
    """/tile PNG (an aligned tile, a 300x200 region across blocks, the
    corner), raw and TIF requests of one layout fixture's channel c."""
    n = data.shape[-1]
    regions = [(n // 4, n // 2, 256, 256, "png"), (100, 70, 300, 200, "png"),
               (n - 100, n - 60, 100, 60, "png"), (33, 44, 120, 90, None),
               (n // 2 - 100, n // 4, 200, 150, "tif")]
    out = []
    for x, y, w, h, fmt in regions:
        q = f"x={x}&y={y}&w={w}&h={h}" + (f"&format={fmt}" if fmt else "")
        out.append((f"/tile/{rid}/0/{c}/0?{q}", fmt, data[0, c, 0, y:y + h, x:x + w]))
    return out


def _check_tile(body: bytes, fmt, want: np.ndarray, path: str) -> None:
    from omero_ms_pixel_buffer_tpu_torch.ops.tiff import decode_tiff

    if fmt == "png":
        got = decode_png(body)
    elif fmt == "tif":
        got = decode_tiff(body)
    else:
        got = np.frombuffer(body, want.dtype.newbyteorder(">")).reshape(want.shape)
    require(np.array_equal(got, want), f"{path}: pixels differ from the source")


def drive_layouts(registry: str, layouts: dict, real_zstd: bool, device: str = "cuda") -> dict:
    """``path_layouts``: a server with the defaults; ``/tile`` PNG, raw and
    TIF of every layout fixture and of the ROMIO image, each checked
    against its source array; ``/render`` (windowed composite, intmax
    projection off a single z) and ``/histogram`` of the float image
    against the port's own quantization and tables in numpy; a float
    render without windows answers 404; the zstd image answers 404
    without the ``zstandard`` package, and its pixels with it."""
    from urllib.parse import parse_qsl

    from omero_ms_pixel_buffer_tpu_torch.render import analysis as ranalysis
    from omero_ms_pixel_buffer_tpu_torch.render import engine as rengine
    from omero_ms_pixel_buffer_tpu_torch.render.luts import LutRegistry
    from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec

    reqs = []
    for rid in LAYOUTS:
        if rid != F32_ID:
            reqs += [(rid,) + r for r in _layout_requests(rid, layouts[rid])]
    for c in range(2):
        reqs += [(ROMIO_ID,) + r for r in _layout_requests(ROMIO_ID, layouts[ROMIO_ID], c)]
    f32 = layouts[F32_ID][0, :, 0]
    render = []
    for x, y, w, h, extra in ((0, 0, 256, 256, ""), (300, 200, 256, 256, ""),
                              (256, 256, 200, 100, "&m=g"), (512, 0, 256, 256, "&p=intmax")):
        query = f"c={F32_C}{extra}" if "m=g" not in extra else "c=2|0:3000&m=g"
        render.append((f"/render/{F32_ID}/0/0/0?x={x}&y={y}&w={w}&h={h}&{query}&format=png",
                       (x, y, w, h), dict(parse_qsl(query))))
    hist = [(f"/histogram/{F32_ID}/0/0/0?x={x}&y={y}&w={w}&h={h}&c=1,2,3&bins={b}",
             (x, y, w, h), b) for x, y, w, h, b in ((0, 0, 256, 256, 256),
                                                     (100, 200, 300, 200, 1000))]
    edge = [(f"/render/{F32_ID}/0/0/0?x=0&y=0&w=64&h=64&c=1,2&format=png", 404),
            (f"/tile/{F32_ID}/0/0/0?x=0&y=0&w=64&h=64&format=png", 404)]
    with ServerThread(registry, device=device) as client:
        tile_out = run_requests(client, [(r[1],) for r in reqs], 16)[0]
        render_out = run_requests(client, [(r[0],) for r in render], 8)[0]
        hist_out = run_requests(client, [(r[0],) for r in hist], 2)[0]
        edge_out = [client.get(path) for path, _ in edge]
        health = get_json(client, "/healthz")
    checked, zstd_404 = 0, 0
    for (status, body, _), (rid, path, fmt, want) in zip(tile_out, reqs):
        if rid == 12 and not real_zstd:
            require(status == 404, f"{path}: zstd without zstandard answered {status}")
            zstd_404 += 1
            continue
        require(status == 200, f"{path} answered {status}")
        _check_tile(body, fmt, want, path)
        checked += 1
    luts = LutRegistry()
    for (status, body, _), (path, (x, y, w, h), query) in zip(render_out, render):
        require(status == 200, f"{path} answered {status}")
        spec = RenderSpec.from_params(query, default_channel=0)
        chans = spec.resolve_channels(3)
        planes = np.stack([rengine.quantize_to_u16(f32[ch.index, y:y + h, x:x + w], ch.window)
                           for ch in chans])
        tables, clut = rengine.build_tables(spec.without_windows(), np.dtype(np.uint16), luts)
        acc = np.zeros((h, w, 3), np.int64)
        for k in range(tables.shape[0]):
            acc += clut[k][tables[k][planes[k]]]
        require(np.array_equal(decode_png(body), np.minimum(acc, 255).astype(np.uint8)),
                f"{path}: pixels differ from the numpy composite")
        checked += 1
    for (status, body, _), (path, (x, y, w, h), bins) in zip(hist_out, hist):
        require(status == 200, f"{path} answered {status}")
        doc = json.loads(body)
        for c, ch in enumerate(doc["channels"]):
            plane = f32[c, y:y + h, x:x + w]
            window = ranalysis.resolve_window(
                ranalysis.HistogramSpec.from_params({"c": str(c + 1)}).channels[0],
                np.dtype(np.float32), False, plane=plane)
            idx = ranalysis.quant_bin_table(bins)[rengine.quantize_to_u16(plane, window)]
            require(ch["counts"] == np.bincount(idx.ravel(), minlength=bins).tolist(),
                    f"{path}: channel {c} counts differ")
        checked += 1
    for (status, _, _), (path, want) in zip(edge_out, edge):
        require(status == want, f"{path} answered {status}, expected {want}")
    require(health["queue"]["failed"] == 0, f"path_layouts: encode groups failed")
    return {"phase": "path_layouts", "fixtures": {rid: name for rid, (name, _) in LAYOUTS.items()},
            "romio": ROMIO_ID, "zstandard": real_zstd, "zstd_404": zstd_404,
            "responses_verified": checked, "edge_statuses": [s for s, _, _ in edge_out],
            "analysis": health["analysis"], "reads": health["reads"]}


def smi_line() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--size", type=int, default=8192)
    p.add_argument("--requests", type=int, default=256,
                   help="timed requests of the dynamic phase")
    p.add_argument("--rle-requests", type=int, default=128,
                   help="timed requests of each rle phase")
    p.add_argument("--stored-requests", type=int, default=32,
                   help="requests of the stored phase")
    p.add_argument("--render-size", type=int, default=4096,
                   help="width and height of the render stack (image 2)")
    p.add_argument("--render-requests", type=int, default=128,
                   help="timed requests of the render phase")
    p.add_argument("--histogram-requests", type=int, default=128,
                   help="timed region requests of the histogram phase (plus 8 full planes)")
    p.add_argument("--viewports", type=int, default=16,
                   help="4x4 viewports of the super-tile phases")
    p.add_argument("--wsi-size", type=int, default=16384,
                   help="width and height of the RGB JPEG pyramid (image 3)")
    p.add_argument("--wsi-requests", type=int, default=512,
                   help="timed tiles of path_wsi (path_wsi_device_idct takes a quarter)")
    p.add_argument("--filter-sweep", action="store_true",
                   help="only build, then time the filter kernel over launch shapes "
                        "(no path phases, no result line)")
    p.add_argument("--bitpack-time", action="store_true",
                   help="only build, then time the scalar-prefetch packer on the real "
                        "pass-2 tokens (no path phases, no result line)")
    p.add_argument("--dense-time", action="store_true",
                   help="only build, then time the dense packer on the real rle tokens "
                        "(no path phases, no result line)")
    p.add_argument("--bitpack-sweep", action="store_true",
                   help="only build, then time the scalar-prefetch kernel's default and "
                        "stamped builds, with the CTAs' phase times "
                        "(no path phases, no result line)")
    p.add_argument("--port-root", default=None,
                   help="import the port package from this checkout instead of the one "
                        "beside this script (to time another version with this code)")
    args = p.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.port_root:
        sys.path.insert(0, os.path.abspath(args.port_root))
    try:
        from omero_ms_pixel_buffer_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    closers = []
    try:
        t0 = time.perf_counter()
        report = _build.build()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "compiled": {k: v["seconds"] for k, v in report.items()},
              "ptxas": {k: [ln.strip() for ln in v["log"].splitlines()
                            if "registers" in ln or "spill" in ln]
                        for k, v in report.items()}})
        t0 = time.perf_counter()
        data = make_field(args.size, args.seed)
        stack = make_stack(args.render_size, args.seed)
        registry = write_fixture(data, stack)
        emit({"phase": "fixture", "size": args.size, "render_stack": list(stack.shape),
              "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        wsi = make_wsi(args.wsi_size, args.seed)
        layouts = layout_data(args.seed)
        wsi_registry, wsi_path, real_zstd = write_wsi_fixtures(wsi, layouts)
        del wsi
        emit({"phase": "fixture_wsi", "size": args.wsi_size, "tile": WSI_TILE,
              "levels": wsi_levels(args.wsi_size), "jpeg": "quality 85, 4:2:0",
              "file_bytes": os.path.getsize(wsi_path), "zstandard": real_zstd,
              "layouts": {rid: name for rid, (name, _) in LAYOUTS.items()},
              "seconds": time.perf_counter() - t0})
        device = torch.device("cuda", 0)
        if args.filter_sweep:
            emit(filter_sweep(torch, device, lane_tiles(data, args.seed)))
            print(smi_line(), flush=True)
            return 0
        if args.bitpack_time or args.dense_time:
            emit(packer_time(torch, device, lane_tiles(data, args.seed), args.dense_time))
            print(smi_line(), flush=True)
            return 0
        if args.bitpack_sweep:
            bitpack_sweep(torch, device, lane_tiles(data, args.seed), args.seed)
            print(smi_line(), flush=True)
            return 0
        kernels = check_kernels(torch, device, lane_tiles(data, args.seed), args.seed)
        render_rows, render_line = check_render_kernels(torch, device, stack, args.seed)
        emit(render_line)
        kernels += render_rows
        # the WSI shapes and the IDCT are timed beside the other kernels,
        # before any server has run in this process
        ref = HostDecode(wsi_path)
        closers.append(ref.close)
        kernels += check_wsi_kernels(torch, device, wsi_tiles(ref, args.seed))
        emit(check_idct(torch, device, wsi_path, args.seed))
        emit(http_contract(registry, data))
        path = drive_path(registry, data, args.seed, args.requests, "dynamic", "pallas",
                          launched=("filter", "bitpack"), idle=("bitpack_dense",))
        require(path["plane_cache"]["hits"] > 0, "plane cache had no hits")
        emit(path)
        rle = drive_path(registry, data, args.seed, args.rle_requests, "rle", "pallas_dense",
                         launched=("filter", "bitpack_dense"), idle=("bitpack",))
        require(rle["plane_cache"]["hits"] > 0, "plane cache had no hits (rle)")
        rle["stream_bytes_mean_dynamic"] = path["stream_bytes_mean"]
        rle["stream_bytes_ratio_rle_to_dynamic"] = (
            rle["stream_bytes_mean"] / path["stream_bytes_mean"])
        emit(rle)
        # the same mode with the dynamic phase's packer: against ``path`` it
        # changes the mode alone
        rle_sp = drive_path(registry, data, args.seed, args.rle_requests, "rle", "pallas",
                            launched=("filter", "bitpack"), idle=("bitpack_dense",),
                            phase="path_rle_sp")
        require(rle_sp["plane_cache"]["hits"] > 0, "plane cache had no hits (rle, pallas)")
        emit(rle_sp)
        stored = drive_path(registry, data, args.seed, args.stored_requests, "stored", "pallas",
                            launched=("filter",), idle=("bitpack", "bitpack_dense"),
                            warm_rounds=0, edges=False)
        emit(stored)
        render = drive_render(registry, stack, args.seed, args.render_requests)
        emit(render)
        emit(drive_host_deflate(registry, data, args.seed))
        emit(drive_histogram(registry, stack, args.seed, args.histogram_requests))
        emit(supertile_pair(registry, stack, args.seed, args.viewports))
        wsi_run = drive_wsi(wsi_registry, ref, args.seed, args.wsi_requests)
        emit(wsi_run)
        emit(drive_wsi(wsi_registry, ref, args.seed, max(LANES, args.wsi_requests // 4),
                       device_idct=True))
        emit(drive_layouts(wsi_registry, layouts, real_zstd))
        # each kernel's launches come from the phase that runs it
        launches = {"filter": path["launches"]["filter"],
                    "bitpack": path["launches"]["bitpack"],
                    "bitpack_dense": rle["launches"]["bitpack_dense"],
                    "filter_render_rgb8": render["launches"]["filter"],
                    "bitpack_render_rle": render["launches"]["bitpack"],
                    "filter_wsi_rgb8": wsi_run["launches"]["filter"],
                    "bitpack_wsi": wsi_run["launches"]["bitpack"]}
        for k in kernels:
            k["launches"] = launches[k["name"]]
        emit({"kernels": kernels})
        print(smi_line(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        for close in closers:
            close()


if __name__ == "__main__":
    sys.exit(main())
