"""The image the server reads, made from the seed: each channel a smooth
field plus Gaussian noise (it compresses as microscopy does, unlike
white noise), written as a tiled OME-TIFF.

Rows are made and compressed in bands of one tile row by a pool of
processes, each band of each channel from its own random stream (seed,
c, z, band), so the pixels do not depend on the number of workers. The
writer is a frozen copy of the tiled, big-endian path of the port's
``write_ome_tiff``, streamed to the file band by band: planes in XYCZT
page order, the OME-XML in the first page, tile data first and the IFDs
after it. The configuration's ``image`` block sets, beside the sizes:

- ``compression``: ``zlib`` (at ``zlib_level``) or ``jpeg`` (uint8
  only; baseline JPEG from Pillow at ``jpeg_quality`` and
  ``jpeg_subsampling``, "4:4:4", "4:2:2" or "4:2:0", as the port writes
  it: abbreviated tile streams, the tables once in tag 347, photometric
  YCbCr for RGB);
- ``pyramid_levels``: levels 1..N-1 as SubIFDs (tag 330), each
  ``[::2, ::2]`` of the level above, of the raw pixels also for JPEG.
  Each band sends its rows of every level back with its tiles, and the
  parent hands each level's band, once whole, to the pool to compress;
- ``samples_per_pixel``: 3 for RGB, interleaved, one page per z
  (channels c..c+2 are the samples of one page);
- ``bigtiff``: the 64-bit-offset layout (magic 43), for files past 4 GB.

Each key's default is the layout of a zlib, one-level, one-sample,
classic TIFF. The samples are clipped to the pixel type's range before
the cast."""

from __future__ import annotations

import collections
import gc
import multiprocessing
import os
import struct
import time
import zlib
from io import BytesIO

import numpy as np

# TIFF tags and types (TIFF 6.0, BigTIFF)
_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC, _DESCRIPTION = 256, 257, 258, 259, 262, 270
_SAMPLES, _TILE_W, _TILE_L, _TILE_OFFSETS, _TILE_COUNTS = 277, 322, 323, 324, 325
_SUB_IFDS, _SAMPLE_FORMAT, _JPEG_TABLES = 330, 339, 347
_ASCII, _SHORT, _LONG, _UNDEFINED, _LONG8 = 2, 3, 4, 7, 16
_PACK = {_SHORT: "H", _LONG: "I", _LONG8: "Q"}
_CODES = {"zlib": 8, "jpeg": 7}
SUBSAMPLING = ("4:4:4", "4:2:2", "4:2:0")

# (entry count format, inline bytes, offset format, offset type)
_Layout = collections.namedtuple("_Layout", "count inline offset offset_type")
_LAYOUTS = {False: _Layout("H", 4, "I", _LONG), True: _Layout("Q", 8, "Q", _LONG8)}


def problems(img: dict) -> list:
    """What the writer cannot make of an ``image`` block (empty when
    nothing)."""
    out = []
    spp = img.get("samples_per_pixel", 1)
    if spp not in (1, 3) or img["size_c"] % spp:
        out.append(f"samples_per_pixel {spp} with size_c {img['size_c']}")
    if img.get("compression", "zlib") not in _CODES:
        out.append(f"compression {img.get('compression')!r}")
    elif img.get("compression") == "jpeg":
        if img["pixel_type"] != "uint8":
            out.append("jpeg needs pixel_type uint8")
        if img.get("jpeg_subsampling", "4:4:4") not in SUBSAMPLING:
            out.append(f"jpeg_subsampling {img.get('jpeg_subsampling')!r}")
    if int(img.get("pyramid_levels", 1)) < 1:
        out.append("pyramid_levels < 1")
    return out


def lossy(img: dict) -> bool:
    return img.get("compression", "zlib") == "jpeg"


def level_size(img: dict, level: int) -> tuple:
    """(width, height) of a pyramid level: each ``[::2, ::2]`` of the one
    above."""
    x, y = img["size_x"], img["size_y"]
    for _ in range(level):
        x, y = -(-x // 2), -(-y // 2)
    return x, y


def _samples(seed: int, c: int, z: int, b: int, img: dict, content: dict) -> np.ndarray:
    """Band ``b`` of channel ``c``'s plane ``z``, from its own stream."""
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
    dtype = np.dtype(img["pixel_type"])
    info = np.iinfo(dtype)
    return (field + noise).clip(info.min, info.max).astype(dtype)


def split_tables(data: bytes) -> tuple:
    """A standalone JPEG -> (its DQT and DHT segments between SOI and EOI,
    the stream without them): TIFF's tag 347 form."""
    tables, stripped, i = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while i < len(data):
        marker = data[i + 1]
        if marker == 0xDA:  # the scan: the rest is entropy data and EOI
            stripped += data[i:]
            break
        end = i + 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
        (tables if marker in (0xDB, 0xC4) else stripped).extend(data[i:end])
        i = end
    return bytes(tables + b"\xff\xd9"), bytes(stripped)


def _tiles(raw: np.ndarray, img: dict) -> tuple:
    """One band of rows of one page at one level -> ([compressed tiles],
    JPEG tables or None)."""
    t = img["tile"]
    be = raw.astype(raw.dtype.newbyteorder(">"))
    tiles, tables = [], None
    for x0 in range(0, raw.shape[1], t):
        block = np.zeros((t, t) + raw.shape[2:], be.dtype)
        sub = be[:, x0:x0 + t]
        block[:sub.shape[0], :sub.shape[1]] = sub
        if lossy(img):
            from PIL import Image

            out = BytesIO()
            Image.fromarray(block).save(
                out, "JPEG", quality=img.get("jpeg_quality", 90),
                subsampling=img.get("jpeg_subsampling", "4:4:4") if block.ndim == 3 else -1)
            tables, stream = split_tables(out.getvalue())
            tiles.append(stream)
        else:
            tiles.append(zlib.compress(block.tobytes(), img["zlib_level"]))
    return tiles, tables


def band(job) -> tuple:
    """One band of rows of one page: (raw pixels (rows, X[, S]) or None,
    [compressed tiles], JPEG tables, [its rows of level k, for k = 1..N-1],
    seconds). ``job`` is (seed, page, z, band index, image spec, content
    spec, whether to compress, whether to return the raw pixels)."""
    seed, p, z, b, img, content, compress, keep = job
    t0 = time.monotonic()
    spp = img.get("samples_per_pixel", 1)
    planes = [_samples(seed, p * spp + s, z, b, img, content) for s in range(spp)]
    raw = planes[0] if spp == 1 else np.stack(planes, axis=-1)
    tiles, tables, levels = [], None, []
    if compress:
        tiles, tables = _tiles(raw, img)
        y0 = b * img["tile"]
        for k in range(1, int(img.get("pyramid_levels", 1))):
            f = 1 << k
            levels.append(np.ascontiguousarray(raw[(-y0) % f::f, ::f]))
    return raw if keep else None, tiles, tables, levels, time.monotonic() - t0


def level_band(job) -> tuple:
    """One band of rows of one page at a level below the first: ([its
    compressed tiles], JPEG tables, seconds)."""
    rows, img = job
    t0 = time.monotonic()
    tiles, tables = _tiles(rows, img)
    return tiles, tables, time.monotonic() - t0


def ome_xml(img: dict) -> str:
    spp = img.get("samples_per_pixel", 1)
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06">'
        '<Image ID="Image:0">'
        f'<Pixels ID="Pixels:0" DimensionOrder="XYCZT" Type="{img["pixel_type"]}" '
        f'SizeX="{img["size_x"]}" SizeY="{img["size_y"]}" SizeZ="{img["size_z"]}" '
        f'SizeC="{img["size_c"]}" SizeT="1" BigEndian="true">'
        + "".join(f'<Channel ID="Channel:0:{c}" SamplesPerPixel="{spp}"/>'
                  for c in range(img["size_c"] // spp))
        + "<TiffData/></Pixels></Image></OME>")


def _ifd(f, img: dict, level: int, offsets, counts, description=None, subs=None,
         tables=None) -> tuple:
    """Write one IFD (out-of-line values first): (its offset, the offset
    of its next-IFD pointer)."""
    lay = _LAYOUTS[bool(img.get("bigtiff", False))]
    spp = img.get("samples_per_pixel", 1)
    bits = 8 * np.dtype(img["pixel_type"]).itemsize
    width, height = level_size(img, level)
    jpeg = lossy(img)
    entries = [
        (_WIDTH, _LONG, [width]), (_LENGTH, _LONG, [height]),
        (_BITS, _SHORT, [bits] * spp), (_COMPRESSION, _SHORT, [_CODES[img.get("compression",
                                                                               "zlib")]]),
        (_PHOTOMETRIC, _SHORT, [(6 if jpeg else 2) if spp == 3 else 1]),
        (_SAMPLES, _SHORT, [spp]),
        (_TILE_W, _SHORT, [img["tile"]]), (_TILE_L, _SHORT, [img["tile"]]),
        (_TILE_OFFSETS, lay.offset_type, offsets), (_TILE_COUNTS, lay.offset_type, counts),
        (_SAMPLE_FORMAT, _SHORT, [1] * spp),
    ]
    if description is not None:
        entries.append((_DESCRIPTION, _ASCII, description.encode() + b"\x00"))
    if subs:
        entries.append((_SUB_IFDS, lay.offset_type, subs))
    if tables is not None:
        entries.append((_JPEG_TABLES, _UNDEFINED, tables))
    entries.sort(key=lambda e: e[0])
    fields = []
    for tag, typ, values in entries:
        if typ in (_ASCII, _UNDEFINED):
            raw = values
        else:
            raw = b"".join(struct.pack(">" + _PACK[typ], v) for v in values)
        if len(raw) <= lay.inline:
            fields.append((tag, typ, len(values), raw.ljust(lay.inline, b"\x00")))
        else:
            if f.tell() % 2:
                f.write(b"\x00")
            fields.append((tag, typ, len(values), struct.pack(">" + lay.offset, f.tell())))
            f.write(raw)
    if f.tell() % 2:
        f.write(b"\x00")
    at = f.tell()
    f.write(struct.pack(">" + lay.count, len(fields)))
    for tag, typ, count, value in fields:
        f.write(struct.pack(">HH" + lay.offset, tag, typ, count) + value)
    nxt = f.tell()
    f.write(struct.pack(">" + lay.offset, 0))  # next page, patched by the caller
    return at, nxt


class Pixels:
    """The reference's pixels, level by level: ``level(k)`` is (C, Z,
    Y_k, X_k), indexed as a numpy array. Of a lossless source every level
    is a strided view of the seed's pixels (``data``). ``stats``: what
    ``write`` spent on each level."""

    def __init__(self, data: np.ndarray, stats=None):
        self.data, self.stats = data, stats

    def level(self, k: int = 0) -> np.ndarray:
        f = 1 << k
        return self.data[:, :, ::f, ::f]

    def close(self) -> None:
        pass


class JpegPixels(Pixels):
    """The pixels a JPEG source's file holds: each tile a region touches
    is read back from the file and decoded by Pillow (libjpeg: the islow
    IDCT, fancy upsampling, its fixed-point YCbCr). No plane is held."""

    CACHED_TILES = 64

    def __init__(self, path: str, img: dict, blocks: dict, tables: bytes, stats=None):
        self.path, self.img, self.blocks, self.tables = path, img, blocks, tables
        self.stats = stats
        self.file = None
        self.decoded: "collections.OrderedDict" = collections.OrderedDict()

    def level(self, k: int = 0) -> "_JpegLevel":
        return _JpegLevel(self, k)

    def close(self) -> None:
        if self.file is not None:
            self.file.close()
            self.file = None

    def tile(self, page: int, z: int, k: int, i: int) -> np.ndarray:
        key = (page, z, k, i)
        if key not in self.decoded:
            from PIL import Image

            if self.file is None:
                self.file = open(self.path, "rb")
            offset, count = self.blocks[page, z, k][0][i], self.blocks[page, z, k][1][i]
            self.file.seek(offset)
            stream = self.file.read(count)
            # the abbreviated stream made whole again: its tables after SOI
            whole = b"\xff\xd8" + self.tables[2:-2] + stream[2:]
            self.decoded[key] = np.asarray(Image.open(BytesIO(whole)))
            if len(self.decoded) > self.CACHED_TILES:
                self.decoded.popitem(last=False)
        return self.decoded[key]

    def region(self, page: int, z: int, k: int, x: int, y: int, w: int, h: int) -> np.ndarray:
        """(h, w[, S]) pixels of one page at level k."""
        t = self.img["tile"]
        across = -(-level_size(self.img, k)[0] // t)
        spp = self.img.get("samples_per_pixel", 1)
        out = np.empty((h, w) + ((spp,) if spp > 1 else ()), np.uint8)
        for ty in range(y // t, (y + h - 1) // t + 1):
            for tx in range(x // t, (x + w - 1) // t + 1):
                tile = self.tile(page, z, k, ty * across + tx)
                y0, y1 = max(y, ty * t), min(y + h, (ty + 1) * t)
                x0, x1 = max(x, tx * t), min(x + w, (tx + 1) * t)
                out[y0 - y:y1 - y, x0 - x:x1 - x] = tile[y0 - ty * t:y1 - ty * t,
                                                         x0 - tx * t:x1 - tx * t]
        return out


class _JpegLevel:
    """One level of a JPEG source as (C, Z, Y, X): ``[c, z, ys, xs]`` with
    ``c`` an index or a slice and ``ys``, ``xs`` slices of step 1."""

    def __init__(self, source: JpegPixels, k: int):
        img = source.img
        self.source, self.k = source, k
        self.dtype = np.dtype(np.uint8)
        self.shape = (img["size_c"], img["size_z"]) + level_size(img, k)[::-1]

    def __getitem__(self, key) -> np.ndarray:
        c, z, ys, xs = key
        spp = self.source.img.get("samples_per_pixel", 1)
        y0, y1, _ = ys.indices(self.shape[2])
        x0, x1, _ = xs.indices(self.shape[3])
        channels = range(self.shape[0])[c] if isinstance(c, slice) else [c]
        pages = {}
        out = []
        for ch in channels:
            page = ch // spp
            if page not in pages:
                pages[page] = self.source.region(page, z, self.k, x0, y0, x1 - x0, y1 - y0)
            region = pages[page]
            out.append(region[:, :, ch % spp] if spp > 1 else region)
        return np.stack(out) if isinstance(c, slice) else out[0]


class _Pool:
    """A pool of spawned processes whose results come back in the order
    the jobs were submitted, with at most ``window`` of the first jobs in
    flight. When it is closed every worker has ended, and so has
    multiprocessing's resource tracker, which the pool's locks start: no
    process of a run outlives the run."""

    def __init__(self, workers: int):
        self.pool = multiprocessing.get_context("spawn").Pool(workers)
        self.pending: collections.deque = collections.deque()
        self.window = 2 * workers

    def submit(self, fn, job, tag) -> None:
        self.pending.append((tag, self.pool.apply_async(fn, (job,))))

    def results(self, first):
        """(tag, result) of the ``first`` jobs ((fn, job, tag), taken as
        room frees) and of each job submitted meanwhile, in order."""
        first = iter(first)
        while True:
            while len(self.pending) < self.window:
                job = next(first, None)
                if job is None:
                    break
                self.submit(*job)
            if not self.pending:
                return
            tag, result = self.pending.popleft()
            yield tag, result.get()

    def close(self, ok: bool) -> None:
        if ok:
            self.pool.close()
        else:
            self.pool.terminate()
        self.pool.join()
        # collected, the pool's locks leave the tracker, which then ends
        # with nothing to clean up
        self.pool = None
        gc.collect()
        from multiprocessing import resource_tracker

        resource_tracker._resource_tracker._stop()


def _pooled(workers: int, first, handle) -> None:
    """Run ``first`` and what ``handle(pool, tag, result)`` submits."""
    pool = _Pool(workers)
    ok = False
    try:
        for tag, result in pool.results(first):
            handle(pool, tag, result)
        ok = True
    finally:
        pool.close(ok)


def _store(data: np.ndarray, img: dict, p: int, z: int, b: int, raw: np.ndarray) -> None:
    """Band ``b`` of page ``p``'s plane ``z`` into (C, Z, Y, X) ``data``."""
    spp, t = img.get("samples_per_pixel", 1), img["tile"]
    rows = slice(b * t, b * t + raw.shape[0])
    for s in range(spp):
        data[p * spp + s, z, rows] = raw if spp == 1 else raw[..., s]


class _Writer:
    """The state of one ``write``: where each page's tiles went, each
    level's rows waiting for a whole band, and the seconds spent."""

    def __init__(self, f, img: dict, data):
        self.f, self.img, self.data = f, img, data
        self.t, self.spp = img["tile"], img.get("samples_per_pixel", 1)
        self.n_levels = int(img.get("pyramid_levels", 1))
        self.bands = -(-img["size_y"] // self.t)
        self.limit = None if img.get("bigtiff", False) else 1 << 32
        self.blocks = collections.defaultdict(lambda: ([], []))  # (page, z, k) -> offsets, counts
        self.rows = collections.defaultdict(list)  # (page, z, k) -> rows not yet in a band
        self.tables = None
        self.stats = {k: {"tiles": 0, "bytes": 0, "worker_s": 0.0, "done_s": 0.0}
                      for k in range(self.n_levels)}
        self.t0 = time.monotonic()

    def put(self, key, tiles, tables, seconds) -> None:
        if tables is not None:
            if self.tables is None:
                self.tables = tables
            elif tables != self.tables:
                raise ValueError("JPEG tiles of one image with different tables")
        offsets, counts = self.blocks[key]
        for tile in tiles:
            offsets.append(self.f.tell())
            counts.append(len(tile))
            self.f.write(tile)
            if len(tile) % 2:
                self.f.write(b"\x00")
        if self.limit is not None and self.f.tell() > self.limit:
            raise ValueError("the image passes 4 GB: set bigtiff")
        s = self.stats[key[2]]
        s["tiles"] += len(tiles)
        s["bytes"] += sum(len(tile) for tile in tiles)
        s["worker_s"] += seconds
        s["done_s"] = time.monotonic() - self.t0

    def handle(self, pool, tag, result) -> None:
        if tag[0] == "level":
            _, key = tag
            tiles, tables, seconds = result
            self.put(key, tiles, tables, seconds)
            return
        _, p, z, b = tag
        raw, tiles, tables, levels, seconds = result
        if self.data is not None:
            _store(self.data, self.img, p, z, b, raw)
        self.put((p, z, 0), tiles, tables, seconds)
        for k, rows in enumerate(levels, start=1):
            key = (p, z, k)
            if len(rows):
                self.rows[key].append(rows)
            waiting = sum(len(r) for r in self.rows[key])
            while waiting >= self.t or (b == self.bands - 1 and waiting):
                joined = np.concatenate(self.rows[key])
                self.rows[key] = [joined[self.t:]] if len(joined) > self.t else []
                pool.submit(level_band, (joined[:self.t], self.img), ("level", key))
                waiting = len(joined) - len(joined[:self.t])

    def ifds(self, img: dict) -> list:
        """Each page's SubIFDs and IFD, in page order: the main IFDs'
        (offset, next pointer)."""
        out = []
        pages = img["size_c"] // self.spp
        for z in range(img["size_z"]):
            for p in range(pages):
                subs = [self._one(p, z, k)[0] for k in range(1, self.n_levels)]
                out.append(self._one(p, z, 0, ome_xml(img) if not out else None, subs))
        return out

    def _one(self, p, z, k, description=None, subs=None) -> tuple:
        offsets, counts = self.blocks[p, z, k]
        return _ifd(self.f, self.img, k, offsets, counts, description, subs, self.tables)


def write(path: str, img: dict, content: dict, seed: int, workers: int) -> Pixels:
    """Make the image from ``seed`` and write it to ``path``; returns the
    reference's pixels (``stats``: each level's tiles, bytes, seconds of
    the workers, and seconds from the start until its last tile)."""
    spp, t = img.get("samples_per_pixel", 1), img["tile"]
    keep = not lossy(img)
    data = (np.empty((img["size_c"], img["size_z"], img["size_y"], img["size_x"]),
                     np.dtype(img["pixel_type"])) if keep else None)
    bands = -(-img["size_y"] // t)
    bigtiff = bool(img.get("bigtiff", False))
    first = ((band, (seed, p, z, b, img, content, True, keep), ("band", p, z, b))
             for z in range(img["size_z"]) for p in range(img["size_c"] // spp)
             for b in range(bands))  # XYCZT pages
    with open(path, "w+b") as f:
        f.write(b"MM\x00+\x00\x08\x00\x00" + b"\x00" * 8 if bigtiff else b"MM\x00*\x00\x00\x00\x00")
        writer = _Writer(f, img, data)
        _pooled(workers, first, writer.handle)
        ifds = writer.ifds(img)
        lay = _LAYOUTS[bigtiff]
        f.seek(8 if bigtiff else 4)
        f.write(struct.pack(">" + lay.offset, ifds[0][0]))
        for (_, pointer), (at, _) in zip(ifds, ifds[1:]):
            f.seek(pointer)
            f.write(struct.pack(">" + lay.offset, at))
        # on the disk before the window opens: write-back of its dirty
        # pages inside the window would take the server's cores
        f.flush()
        os.fsync(f.fileno())
    if keep:
        return Pixels(data, writer.stats)
    return JpegPixels(path, img, dict(writer.blocks), writer.tables, writer.stats)


def pixels(img: dict, content: dict, seed: int, workers: int) -> Pixels:
    """The pixels ``write`` makes from ``seed``, without a file (a lossless
    source's; a JPEG source's pixels are what its file holds)."""
    if lossy(img):
        raise ValueError("the pixels of a JPEG source are its file's: write it")
    spp, t = img.get("samples_per_pixel", 1), img["tile"]
    data = np.empty((img["size_c"], img["size_z"], img["size_y"], img["size_x"]),
                    np.dtype(img["pixel_type"]))
    first = ((band, (seed, p, z, b, img, content, False, True), ("band", p, z, b))
             for z in range(img["size_z"]) for p in range(img["size_c"] // spp)
             for b in range(-(-img["size_y"] // t)))
    _pooled(workers, first, lambda pool, tag, result: _store(data, img, *tag[1:], result[0]))
    return Pixels(data)


def default_workers() -> int:
    return max(1, len(os.sched_getaffinity(0)))
