"""The image the server reads, made from the seed: each channel a smooth
field plus Gaussian noise (it compresses as microscopy does, unlike
white noise), written as a tiled OME-TIFF with zlib tiles.

Rows are made and compressed in bands of one tile row by a pool of
processes, each band from its own random stream (seed, c, z, band), so
the pixels do not depend on the number of workers. The writer is a
frozen copy of the tiled, zlib, big-endian path of the port's
``write_ome_tiff`` (classic TIFF, planes in XYCZT page order, the
OME-XML in the first page), streamed to the file band by band."""

from __future__ import annotations

import gc
import multiprocessing
import os
import struct
import zlib

import numpy as np

# TIFF tags and types (TIFF 6.0)
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC, _DESCRIPTION = 256, 257, 258, 259, 262, 270
_SAMPLES, _TILE_W, _TILE_L, _TILE_OFFSETS, _TILE_COUNTS, _SAMPLE_FORMAT = 277, 322, 323, 324, 325, 339
_ASCII, _SHORT, _LONG = 2, 3, 4


def band(job) -> tuple:
    """One band of rows of one plane: (raw pixels (rows, X), [compressed
    tiles]). ``job`` is (seed, c, z, band index, image spec, content spec,
    whether to compress)."""
    seed, c, z, b, img, content, compress = job
    t, size_x, size_y = img["tile"], img["size_x"], img["size_y"]
    ch = content["channels"][c]
    y0 = b * t
    rows = min(t, size_y - y0)
    rng = np.random.default_rng([seed, c, z, b])
    xs = np.arange(size_x, dtype=np.float64)
    ys = np.arange(y0, y0 + rows, dtype=np.float64)
    drift = ch["drift_z"] * z
    field = (ch["level"] + ch["amp_x"] * np.sin(xs / ch["period_x"] + drift))[None, :] \
        + (ch["amp_y"] * np.cos(ys / ch["period_y"] - drift))[:, None]
    noise = rng.standard_normal((rows, size_x), dtype=np.float32) * content["noise_sigma"]
    raw = (field + noise).clip(0, 65535).astype(np.dtype(img["pixel_type"]))
    if not compress:
        return raw, []
    be = raw.astype(raw.dtype.newbyteorder(">"))
    tiles = []
    for x0 in range(0, size_x, t):
        block = np.zeros((t, t), be.dtype)
        sub = be[:, x0:x0 + t]
        block[:sub.shape[0], :sub.shape[1]] = sub
        tiles.append(zlib.compress(block.tobytes(), img["zlib_level"]))
    return raw, tiles


def ome_xml(img: dict) -> str:
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06">'
        '<Image ID="Image:0">'
        f'<Pixels ID="Pixels:0" DimensionOrder="XYCZT" Type="{img["pixel_type"]}" '
        f'SizeX="{img["size_x"]}" SizeY="{img["size_y"]}" SizeZ="{img["size_z"]}" '
        f'SizeC="{img["size_c"]}" SizeT="1" BigEndian="true">'
        + "".join(f'<Channel ID="Channel:0:{c}" SamplesPerPixel="1"/>'
                  for c in range(img["size_c"]))
        + "<TiffData/></Pixels></Image></OME>")


def _ifd(f, img: dict, offsets, counts, description) -> tuple:
    """Write one page's IFD (out-of-line values first): (its offset, the
    offset of its next-page pointer)."""
    item = np.dtype(img["pixel_type"]).itemsize
    entries = [
        (_WIDTH, _LONG, [img["size_x"]]), (_LENGTH, _LONG, [img["size_y"]]),
        (_BITS, _SHORT, [8 * item]), (_COMPRESSION, _SHORT, [8]),
        (_PHOTOMETRIC, _SHORT, [1]), (_SAMPLES, _SHORT, [1]),
        (_TILE_W, _SHORT, [img["tile"]]), (_TILE_L, _SHORT, [img["tile"]]),
        (_TILE_OFFSETS, _LONG, offsets), (_TILE_COUNTS, _LONG, counts),
        (_SAMPLE_FORMAT, _SHORT, [1]),
    ]
    if description is not None:
        entries.append((_DESCRIPTION, _ASCII, description.encode() + b"\x00"))
    entries.sort(key=lambda e: e[0])
    fields = []
    for tag, typ, values in entries:
        if typ == _ASCII:
            raw, count = values, len(values)
        else:
            raw = b"".join(struct.pack(">H" if typ == _SHORT else ">I", v) for v in values)
            count = len(values)
        if len(raw) <= 4:
            fields.append((tag, typ, count, raw.ljust(4, b"\x00")))
        else:
            if f.tell() % 2:
                f.write(b"\x00")
            fields.append((tag, typ, count, struct.pack(">I", f.tell())))
            f.write(raw)
    if f.tell() % 2:
        f.write(b"\x00")
    at = f.tell()
    f.write(struct.pack(">H", len(fields)))
    for tag, typ, count, value in fields:
        f.write(struct.pack(">HHI", tag, typ, count) + value)
    nxt = f.tell()
    f.write(struct.pack(">I", 0))  # next page, patched by the caller
    return at, nxt


def write(path: str, img: dict, content: dict, seed: int, workers: int) -> np.ndarray:
    """Make the image from ``seed`` and write it to ``path``; returns the
    pixels as (C, Z, Y, X)."""
    c_n, z_n, t = img["size_c"], img["size_z"], img["tile"]
    bands = -(-img["size_y"] // t)
    data = np.empty((c_n, z_n, img["size_y"], img["size_x"]), np.dtype(img["pixel_type"]))
    jobs = [(seed, c, z, b, img, content, True)
            for z in range(z_n) for c in range(c_n) for b in range(bands)]  # XYCZT pages
    pages = []
    with open(path, "w+b") as f:
        f.write(b"MM\x00*\x00\x00\x00\x00")
        offsets, counts = [], []
        for (_, c, z, b, _, _, _), (raw, tiles) in _bands(jobs, workers):
            data[c, z, b * t:b * t + raw.shape[0]] = raw
            for tile in tiles:
                offsets.append(f.tell())
                counts.append(len(tile))
                f.write(tile)
                if len(tile) % 2:
                    f.write(b"\x00")
            if b == bands - 1:
                pages.append((offsets, counts))
                offsets, counts = [], []
        ifds = [_ifd(f, img, o, n, ome_xml(img) if k == 0 else None)
                for k, (o, n) in enumerate(pages)]
        f.seek(4)
        f.write(struct.pack(">I", ifds[0][0]))
        for (_, pointer), (at, _) in zip(ifds, ifds[1:]):
            f.seek(pointer)
            f.write(struct.pack(">I", at))
        # on the disk before the window opens: write-back of its dirty
        # pages inside the window would take the server's cores
        f.flush()
        os.fsync(f.fileno())
    return data


def pixels(img: dict, content: dict, seed: int, workers: int) -> np.ndarray:
    """The pixels ``write`` makes from ``seed``, without a file."""
    t, bands = img["tile"], -(-img["size_y"] // img["tile"])
    data = np.empty((img["size_c"], img["size_z"], img["size_y"], img["size_x"]),
                    np.dtype(img["pixel_type"]))
    jobs = [(seed, c, z, b, img, content, False)
            for z in range(img["size_z"]) for c in range(img["size_c"]) for b in range(bands)]
    for (_, c, z, b, *_), (raw, _) in _bands(jobs, workers):
        data[c, z, b * t:b * t + raw.shape[0]] = raw
    return data


def _bands(jobs: list, workers: int):
    """(job, band(job)) for each job, in order, from a pool of spawned
    processes. When the last is out, every worker has ended, and so has
    multiprocessing's resource tracker, which the pool's locks start: no
    process of a run outlives the run."""
    pool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        yield from zip(jobs, pool.imap(band, jobs))
        pool.close()
    except BaseException:
        pool.terminate()
        raise
    finally:
        pool.join()
        # collected, the pool's locks leave the tracker, which then ends
        # with nothing to clean up
        pool = None
        gc.collect()
        from multiprocessing import resource_tracker

        resource_tracker._resource_tracker._stop()


def default_workers() -> int:
    return max(1, len(os.sched_getaffinity(0)))
