"""OME-TIFF pixel buffer, reader and writer (counterpart of
``omero_ms_pixel_buffer_tpu/io/ometiff.py``, at its scope).

Layouts read and written:

- classic (magic 42) or BigTIFF (magic 43), big- or little-endian;
  planes in XYCZT page order (C fastest), pyramid levels in SubIFDs
  (tag 330), 2x downsampled;
- tiled (TileWidth/TileLength) or stripped (RowsPerStrip) storage;
- compression none (1), LZW (5), JPEG (7: baseline, abbreviated streams
  with tables in tag 347, photometric 2 or 6), deflate (8), PackBits
  (32773), zstd (50000, needs the ``zstandard`` package: without it a
  read of a zstd plane raises, as in the JAX reader); predictor 2
  (horizontal differencing) after any of them but JPEG;
- 8/16/32/64-bit samples, unsigned, signed or float (SampleFormat 3);
- one sample per pixel, or three interleaved: with OME ``SizeC`` a
  multiple of the samples and the page count to match, channel c of a
  page is its sample c; otherwise (a scanner's RGB TIFF) a read gives
  (h, w, 3) tiles;
- OME-XML in the first IFD's ImageDescription carrying SizeX/Y/Z/C/T,
  Type and DimensionOrder (falls back to page counting when it lies).

Reads are batched (``read_tiles``): every compressed block the regions
touch, across tiles and planes, is deduplicated and decoded once. Blocks
of zlib, LZW and PackBits go to the native engine's pool in one call
(``runtime/native``); JPEG and zstd blocks decode in Python; without the
native engine every block decodes in Python on a thread pool. A corrupt
block fails only the lanes that touch it. Decoded blocks are kept in the
shared ``BlockCache``. ``memo_dir`` (or ``OMPB_MEMO_DIR``) keeps the
parsed IFD chain as JSON beside first use, so a restart skips the walk.
"""

from __future__ import annotations

import base64
import collections
import concurrent.futures
import hashlib
import json
import logging
import mmap
import os
import re
import struct
import tempfile
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops import codecs as _codecs
from ..ops.convert import dtype_for, omero_type_for
from .pixel_buffer import BlockCache, PixelBuffer, PixelsMeta, check_bounds

_T = {"WIDTH": 256, "LENGTH": 257, "BITS": 258, "COMPRESSION": 259,
      "PHOTOMETRIC": 262, "DESCRIPTION": 270, "STRIP_OFFSETS": 273,
      "SAMPLES": 277, "ROWS_PER_STRIP": 278, "STRIP_COUNTS": 279,
      "PREDICTOR": 317, "TILE_WIDTH": 322, "TILE_LENGTH": 323,
      "TILE_OFFSETS": 324, "TILE_COUNTS": 325, "SUB_IFDS": 330,
      "SAMPLE_FORMAT": 339, "JPEG_TABLES": 347}

# TIFF compression codes served: 1 none, 5 LZW, 7 new-style JPEG,
# 8 deflate, 32773 PackBits, 50000 zstd
_SUPPORTED_COMPRESSIONS = (1, 5, 7, 8, 32773, 50000)

# codecs the native batch decoder does not handle: their blocks decode
# in Python on the batched read
_PYTHON_SIDE_CODECS = (7, 50000)

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 16: "Q"}

# classic vs BigTIFF layout: entry-count format/width, entry width,
# inline-value width, offset format, TIFF type of offset arrays
_Flavor = collections.namedtuple(
    "_Flavor", "cnt_fmt cnt_len entry_len inline off_fmt off_typ"
)
_TIFF_FLAVORS = {
    False: _Flavor("H", 2, 12, 4, "I", 4),    # classic, magic 42
    True: _Flavor("Q", 8, 20, 8, "Q", 16),    # BigTIFF, magic 43
}

# without the native engine, decode blocks on a thread pool when a batch
# needs at least this many (zlib and zstd release the GIL)
_PARALLEL_BLOCKS = 4

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.io.ometiff")


class TiffError(ValueError):
    pass


class _Ifd:
    """One parsed IFD: tag dict (+ ``sub_ifds`` for pyramid levels)."""

    def __init__(self, tags: Dict[int, list]):
        self.tags = tags
        self.sub_ifds: List["_Ifd"] = []
        self.jpeg_tables = None  # tag 347 parsed on first use (False: none)

    def first(self, tag: str, default=None):
        v = self.tags.get(_T[tag])
        return v[0] if v else default

    def values(self, tag: str) -> list:
        return self.tags.get(_T[tag], [])

    @property
    def width(self) -> int:
        return self.first("WIDTH")

    @property
    def height(self) -> int:
        return self.first("LENGTH")

    @property
    def tiled(self) -> bool:
        return _T["TILE_OFFSETS"] in self.tags


def _parse_ifds(data) -> Tuple[str, List[_Ifd]]:
    """(byte order, main IFDs with their ``sub_ifds``)."""
    if data[:2] == b"II":
        bo = "<"
    elif data[:2] == b"MM":
        bo = ">"
    else:
        raise TiffError("Not a TIFF file")
    try:
        return bo, _parse_chain(data, bo)
    except (struct.error, IndexError, MemoryError, OverflowError) as e:
        raise TiffError(f"Corrupt TIFF structure: {e}") from None


def _parse_chain(data, bo: str) -> List[_Ifd]:
    (magic,) = struct.unpack(bo + "H", data[2:4])
    if magic == 42:
        big = False
        (first_off,) = struct.unpack(bo + "I", data[4:8])
    elif magic == 43:
        big = True
        offsize, reserved = struct.unpack(bo + "HH", data[4:8])
        if offsize != 8 or reserved != 0:
            raise TiffError("Malformed BigTIFF header")
        (first_off,) = struct.unpack(bo + "Q", data[8:16])
    else:
        raise TiffError(f"Unknown TIFF magic: {magic}")
    fl = _TIFF_FLAVORS[big]

    def parse_one(off: int) -> Tuple[_Ifd, int]:
        (n,) = struct.unpack(bo + fl.cnt_fmt, data[off: off + fl.cnt_len])
        if n > 65536:  # a corrupt 64-bit entry count must not spin
            raise TiffError(f"IFD claims {n} entries")
        tags: Dict[int, list] = {}
        for i in range(n):
            eo = off + fl.cnt_len + fl.entry_len * i
            tag, typ = struct.unpack(bo + "HH", data[eo: eo + 4])
            (count,) = struct.unpack(
                bo + fl.off_fmt, data[eo + 4: eo + 4 + fl.inline]
            )
            size = _TYPE_SIZES.get(typ, 1) * count
            if size > len(data):  # a corrupt count must not drive allocation
                raise TiffError(
                    f"Tag {tag} claims {size} value bytes in a "
                    f"{len(data)}-byte file"
                )
            val_off = eo + 4 + fl.inline
            raw = data[val_off: val_off + fl.inline]
            if size > fl.inline:
                (ptr,) = struct.unpack(bo + fl.off_fmt, raw)
                raw = data[ptr: ptr + size]
            else:
                raw = raw[:size]
            if typ in _TYPE_FMT:
                tags[tag] = list(struct.unpack(bo + f"{count}{_TYPE_FMT[typ]}", raw))
            elif typ == 2:  # ASCII
                tags[tag] = [bytes(raw).rstrip(b"\x00").decode("utf-8", "replace")]
            elif typ == 7:  # UNDEFINED: opaque bytes (JPEGTables)
                tags[tag] = [bytes(raw)]
        nxt_off = off + fl.cnt_len + fl.entry_len * n
        (nxt,) = struct.unpack(bo + fl.off_fmt, data[nxt_off: nxt_off + fl.inline])
        return _Ifd(tags), nxt

    ifds: List[_Ifd] = []
    off = first_off
    while off:
        ifd, off = parse_one(off)
        ifd.sub_ifds = [parse_one(so)[0] for so in ifd.values("SUB_IFDS")]
        ifds.append(ifd)
        if len(ifds) > 1_000_000:
            raise TiffError("IFD chain too long")
    return ifds


_OME_RE = {
    k: re.compile(rf'{k}="([^"]+)"')
    for k in ("SizeX", "SizeY", "SizeZ", "SizeC", "SizeT", "Type",
              "DimensionOrder")
}


def _parse_ome(desc: str) -> Optional[dict]:
    if "OME" not in desc or "Pixels" not in desc:
        return None
    out = {}
    for k, rx in _OME_RE.items():
        m = rx.search(desc)
        if m:
            out[k] = m.group(1)
    return out or None


_pure_lzw_warned = False


def _warn_pure_python_lzw_once() -> None:
    """The sequential read path decodes LZW in pure Python; without the
    native engine that is a seconds-per-tile cliff an operator should
    hear about once."""
    global _pure_lzw_warned
    if _pure_lzw_warned:
        return
    from ..runtime.native import get_engine

    _pure_lzw_warned = True
    if get_engine() is None:
        log.warning(
            "serving LZW-compressed TIFF with the pure-Python decoder "
            "(native engine unavailable): expect seconds-per-tile latency; "
            "check the native build (OMPB_DISABLE_NATIVE, g++)"
        )


class _LevelReader:
    """Block access within one IFD (one plane at one level): *plan* (the
    blocks a region touches, their spans and decoded capacities), *decode*
    and *assemble* (crop decoded blocks into the output array), so batched
    reads decode every block of a batch at once."""

    def __init__(self, fh, bo: str, ifd: _Ifd, dtype: np.dtype, samples: int,
                 cache: Optional[BlockCache] = None, cache_ns: int = 0,
                 device_idct=None):
        self.fh = fh
        self.bo = bo
        self.ifd = ifd
        self.dtype = dtype.newbyteorder(bo)
        self.samples = samples
        self.cache = cache
        self.cache_ns = cache_ns
        self.device_idct = device_idct
        self.compression = ifd.first("COMPRESSION", 1)
        if self.compression not in _SUPPORTED_COMPRESSIONS:
            raise TiffError(f"Unsupported compression: {self.compression}")
        self.predictor = ifd.first("PREDICTOR", 1)
        if self.predictor not in (1, 2):
            raise TiffError(f"Unsupported predictor: {self.predictor}")
        if self.compression == 7:
            if self.predictor == 2:
                raise TiffError("predictor 2 is invalid with JPEG")
            if dtype != np.dtype(np.uint8):
                raise TiffError("JPEG-in-TIFF requires 8-bit samples")
        if self.compression == 50000:
            try:  # fail fast, not per block as "corrupt"
                import zstandard  # noqa: F401
            except ImportError:
                raise TiffError(
                    "zstd-compressed TIFF requires the zstandard package"
                ) from None

    @property
    def compressed(self) -> bool:
        return self.compression != 1

    def block_key(self, i: int) -> tuple:
        return (self.cache_ns, id(self.ifd), i)

    def _block_geometry(self) -> Tuple[int, int]:
        """(width, rows) of a full decoded block."""
        ifd = self.ifd
        if ifd.tiled:
            return ifd.first("TILE_WIDTH"), ifd.first("TILE_LENGTH")
        return ifd.width, min(ifd.first("ROWS_PER_STRIP", ifd.height), ifd.height)

    def decode_jpeg_block(self, raw) -> Optional[np.ndarray]:
        """One JPEG block (compression 7) -> flat uint8 pixel bytes at the
        block's decoded capacity, or None when corrupt. Tables from tag
        347 (abbreviated streams) seed the decoder, parsed once per IFD;
        a stream smaller than the block pads bottom/right. A device IDCT
        failure raises ``DeviceIdctError``."""
        from .jpeg import JpegError, decode_jpeg, parse_tables

        ifd = self.ifd
        if ifd.jpeg_tables is None:
            blobs = ifd.values("JPEG_TABLES")
            try:
                if blobs and isinstance(blobs[0], (bytes, bytearray)):
                    ifd.jpeg_tables = parse_tables(bytes(blobs[0]))
                elif blobs:  # written as BYTE values (ints)
                    ifd.jpeg_tables = parse_tables(bytes(blobs))
                else:
                    ifd.jpeg_tables = False  # standalone streams
            except JpegError:
                return None
        # photometric 6 (YCbCr) converts; 2 means components are RGB
        ycbcr = ifd.first("PHOTOMETRIC", 6) != 2
        bw, bh = self._block_geometry()
        try:
            pixels = decode_jpeg(
                bytes(raw), tables=ifd.jpeg_tables or None, ycbcr=ycbcr,
                # SOF dims may not exceed the block: a hostile stream
                # must not size the coefficient buffers
                max_pixels=bw * bh, device_idct=self.device_idct,
            )
        except JpegError:
            return None
        if pixels.ndim == 2:
            pixels = pixels[:, :, None]
        if pixels.shape[2] != self.samples:
            return None
        if pixels.shape[0] > bh or pixels.shape[1] > bw:
            pixels = pixels[:bh, :bw]
        if pixels.shape[:2] != (bh, bw):
            padded = np.zeros((bh, bw, self.samples), np.uint8)
            padded[: pixels.shape[0], : pixels.shape[1]] = pixels
            pixels = padded
        return np.ascontiguousarray(pixels).reshape(-1)

    def row_samples(self) -> int:
        """Samples per decoded-block row (tile width or image width)."""
        return self._block_geometry()[0] * self.samples

    def postprocess(self, arr: np.ndarray) -> np.ndarray:
        """Undo the horizontal-differencing predictor (tag 317 = 2) on
        freshly decoded block bytes. Cached blocks are post-predictor."""
        if self.predictor != 2 or not self.compressed:
            return arr
        rs = self.row_samples()
        row_bytes = rs * self.dtype.itemsize
        usable = (len(arr) // row_bytes) * row_bytes
        return _codecs.undo_predictor2(
            arr[:usable], rs, self.dtype.itemsize, self.samples, self.bo)

    def decode_span(self, raw, cap: int) -> Optional[np.ndarray]:
        """One compressed block's bytes -> decoded, post-predictor uint8
        bytes, in Python; None when corrupt."""
        if self.compression == 7:
            return self.decode_jpeg_block(raw)
        if self.compression == 8:
            plain = _codecs.bounded_inflate(bytes(raw), cap)
        elif self.compression == 5:
            _warn_pure_python_lzw_once()
            plain = _codecs.lzw_decode(bytes(raw), cap)
        elif self.compression == 50000:
            plain = _codecs.bounded_zstd(bytes(raw), cap)
        else:  # 32773
            plain = _codecs.packbits_decode(bytes(raw), cap)
        if plain is None:
            return None
        return self.postprocess(np.frombuffer(plain, dtype=np.uint8))

    def plan_region(self, x: int, y: int, w: int, h: int) -> List[int]:
        """Indices of the on-disk blocks (tiles or strips) the region
        touches."""
        ifd = self.ifd
        if ifd.tiled:
            tw, th = ifd.first("TILE_WIDTH"), ifd.first("TILE_LENGTH")
            across = (ifd.width + tw - 1) // tw
            return [
                ty * across + tx
                for ty in range(y // th, (y + h - 1) // th + 1)
                for tx in range(x // tw, (x + w - 1) // tw + 1)
            ]
        rps = ifd.first("ROWS_PER_STRIP", ifd.height)
        return list(range(y // rps, (y + h - 1) // rps + 1))

    def block_span(self, i: int) -> Tuple[int, int, int]:
        """(file offset, byte count, decoded capacity) of block i."""
        ifd = self.ifd
        per_px = self.samples * self.dtype.itemsize
        if ifd.tiled:
            cap = ifd.first("TILE_WIDTH") * ifd.first("TILE_LENGTH") * per_px
            offs, cnts = ifd.values("TILE_OFFSETS"), ifd.values("TILE_COUNTS")
        else:
            rps = ifd.first("ROWS_PER_STRIP", ifd.height)
            cap = min(rps, ifd.height - i * rps) * ifd.width * per_px
            offs, cnts = ifd.values("STRIP_OFFSETS"), ifd.values("STRIP_COUNTS")
        return offs[i], cnts[i], cap

    def _read_block(self, i: int):
        """Block i decoded (through the block cache) or, uncompressed, its
        file bytes; raises TiffError when corrupt."""
        key = self.block_key(i)
        if self.cache is not None and self.compressed:
            hit = self.cache.get(key)
            if hit is not None:
                return hit
        offset, count, cap = self.block_span(i)
        raw = self.fh[offset: offset + count]
        if not self.compressed:
            return raw
        decoded = self.decode_span(raw, cap)
        if decoded is None:
            kind = "JPEG block" if self.compression == 7 else "block"
            suffix = "" if self.compression == 7 else f" (compression {self.compression})"
            raise TiffError(f"Corrupt {kind} {i}{suffix}")
        if self.cache is not None:
            self.cache.put(key, decoded)
        return decoded

    def read_region(self, x: int, y: int, w: int, h: int, get_block=None) -> np.ndarray:
        """Crop the region from decoded blocks; ``get_block(i)`` supplies
        them (default: read and decode through the block cache)."""
        get_block = get_block or self._read_block
        ifd = self.ifd
        W, H = ifd.width, ifd.height
        S = self.samples
        tail = (S,) if S > 1 else ()
        out = np.zeros((h, w) + tail, dtype=self.dtype.newbyteorder("="))
        if ifd.tiled:
            tw, th = ifd.first("TILE_WIDTH"), ifd.first("TILE_LENGTH")
            across = (W + tw - 1) // tw
            for ty in range(y // th, (y + h - 1) // th + 1):
                for tx in range(x // tw, (x + w - 1) // tw + 1):
                    tile = np.frombuffer(get_block(ty * across + tx), dtype=self.dtype)
                    tile = tile[: th * tw * S].reshape((th, tw) + tail)
                    y0, x0 = ty * th, tx * tw
                    lo_y, hi_y = max(y, y0), min(y + h, y0 + th, H)
                    lo_x, hi_x = max(x, x0), min(x + w, x0 + tw, W)
                    if hi_y <= lo_y or hi_x <= lo_x:
                        continue
                    out[lo_y - y: hi_y - y, lo_x - x: hi_x - x] = tile[
                        lo_y - y0: hi_y - y0, lo_x - x0: hi_x - x0
                    ]
        else:
            rps = ifd.first("ROWS_PER_STRIP", H)
            for si in range(y // rps, (y + h - 1) // rps + 1):
                rows_here = min(rps, H - si * rps)
                strip = np.frombuffer(get_block(si), dtype=self.dtype)
                strip = strip[: rows_here * W * S].reshape((rows_here, W) + tail)
                y0 = si * rps
                lo_y, hi_y = max(y, y0), min(y + h, y0 + rows_here)
                if hi_y <= lo_y:
                    continue
                out[lo_y - y: hi_y - y, :] = strip[lo_y - y0: hi_y - y0, x: x + w]
        return out


# -- the IFD memo (the Bio-Formats Memoizer's role) ---------------------------


def _memo_key(path: str) -> str:
    # stable per-path name (rewrites overwrite rather than orphan);
    # freshness is checked against the stamp saved inside the memo
    return hashlib.sha256(os.path.abspath(path).encode()).hexdigest()


def _memo_stamp(path: str):
    st = os.stat(path)
    return (st.st_mtime_ns, st.st_size)


_MEMO_BYTES_MARKER = "\x00b64:"  # NUL prefix: impossible in TIFF ASCII


def _memo_tags_to_json(tags: Dict[int, list]) -> dict:
    return {
        str(k): [_MEMO_BYTES_MARKER + base64.b64encode(item).decode()
                 if isinstance(item, (bytes, bytearray)) else item for item in v]
        for k, v in tags.items()
    }


def _memo_tags_from_json(obj: dict) -> Dict[int, list]:
    tags: Dict[int, list] = {}
    for k, v in obj.items():
        if not isinstance(v, list):
            raise ValueError("tag values must be lists")
        vals = []
        for item in v:
            if isinstance(item, str) and item.startswith(_MEMO_BYTES_MARKER):
                vals.append(base64.b64decode(item[len(_MEMO_BYTES_MARKER):]))
            elif isinstance(item, (int, str)):
                vals.append(item)
            else:
                raise ValueError("tag values must be int/str")
        tags[int(k)] = vals
    return tags


def _memo_load(path: str, memo_dir: str):
    """(byte order, IFDs) from the memo, or None. A memo whose recorded
    mtime/size does not match the file is stale and ignored. The format
    is JSON, not pickle: loading a memo never executes code, even from a
    directory others can write."""
    memo = os.path.join(memo_dir, _memo_key(path) + ".ifd.json")
    try:
        with open(memo, "rb") as f:
            doc = json.load(f)
        # v2: v1 memos (the JAX package's first format) dropped type-7
        # tags, losing JPEGTables (347)
        if doc.get("v") != 2 or tuple(doc["stamp"]) != _memo_stamp(path):
            return None
        bo = doc["bo"]
        if bo not in ("<", ">"):
            return None
        ifds = []
        for entry in doc["ifds"]:
            ifd = _Ifd(_memo_tags_from_json(entry["tags"]))
            ifd.sub_ifds = [_Ifd(_memo_tags_from_json(t)) for t in entry["sub"]]
            ifds.append(ifd)
        return bo, ifds
    except Exception:
        # any malformed or foreign memo (torn write, format drift)
        # degrades to a reparse, never an open error
        return None


def _memo_save(path: str, memo_dir: str, bo: str, ifds) -> None:
    try:
        os.makedirs(memo_dir, mode=0o700, exist_ok=True)
        doc = {
            "v": 2,
            "stamp": list(_memo_stamp(path)),
            "bo": bo,
            "ifds": [{"tags": _memo_tags_to_json(ifd.tags),
                      "sub": [_memo_tags_to_json(s.tags) for s in ifd.sub_ifds]}
                     for ifd in ifds],
        }
        memo = os.path.join(memo_dir, _memo_key(path) + ".ifd.json")
        # a unique temporary per writer (two threads may race the first
        # open of one image); os.replace publishes atomically
        fd, tmp = tempfile.mkstemp(dir=memo_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(doc, f, separators=(",", ":"))
            os.replace(tmp, memo)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError as e:
        log.debug("memo save failed for %s: %s", path, e)


class OmeTiffPixelBuffer(PixelBuffer):
    """OME-TIFF (optionally pyramidal) as a PixelBuffer. ``device_idct``
    (an ``io.jpeg.DeviceIdct``) runs JPEG blocks' device IDCT when
    ``OMPB_JPEG_DEVICE_IDCT=1``; ``memo_dir`` (default ``OMPB_MEMO_DIR``)
    keeps the parsed IFD chain."""

    def __init__(self, path: str, image_id: int = 0, image_name: str = "",
                 block_cache: Optional[BlockCache] = None,
                 memo_dir: Optional[str] = None, device_idct=None):
        self.path = path
        self.memo_dir = memo_dir or os.environ.get("OMPB_MEMO_DIR")
        self.device_idct = device_idct
        self.block_cache = block_cache if block_cache is not None else BlockCache()
        self._file = open(path, "rb")
        try:
            self.mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
            self._init_meta(image_id, image_name)
        except BaseException:
            self.close()
            raise

    def _init_meta(self, image_id: int, image_name: str) -> None:
        loaded = _memo_load(self.path, self.memo_dir) if self.memo_dir else None
        if loaded is not None:
            self.bo, self.ifds = loaded
        else:
            self.bo, self.ifds = _parse_ifds(self.mm)
            if self.memo_dir:
                _memo_save(self.path, self.memo_dir, self.bo, self.ifds)
        if not self.ifds:
            raise TiffError(f"No IFDs in {self.path}")
        first = self.ifds[0]
        bits = first.first("BITS", 8)
        samples = first.first("SAMPLES", 1)
        kind = {1: "u", 2: "i", 3: "f"}.get(first.first("SAMPLE_FORMAT", 1))
        if kind is None or bits not in (8, 16, 32, 64) or (kind == "f" and bits < 32):
            raise TiffError(f"Unsupported samples: {bits}-bit format "
                            f"{first.first('SAMPLE_FORMAT', 1)}")
        base_dtype = np.dtype(f"{kind}{bits // 8}")
        self.samples = samples
        ome = _parse_ome(first.first("DESCRIPTION", "") or "") or {}
        ptype = ome.get("Type") or omero_type_for(base_dtype)
        sz, sc, st = (int(ome.get(k, 1)) for k in ("SizeZ", "SizeC", "SizeT"))
        self.dim_order = ome.get("DimensionOrder", "XYCZT")
        # OMERO models RGB as SizeC = 3 with per-channel reads; an
        # interleaved TIFF stores those channels in the samples of one
        # page. When the page count reconciles that way, channel c is
        # sample c of the shared page.
        self._channels_per_plane = 1
        if samples > 1 and sc % samples == 0 and sz * (sc // samples) * st == len(self.ifds):
            self._channels_per_plane = samples
        elif sz * sc * st > len(self.ifds):
            sz, sc, st = 1, 1, len(self.ifds)  # metadata lies: page count
        super().__init__(PixelsMeta(
            image_id=image_id, size_x=first.width, size_y=first.height,
            size_z=sz, size_c=sc, size_t=st, pixels_type=ptype,
            image_name=image_name or os.path.basename(self.path),
        ))
        self._dtype = dtype_for(ptype)

    def _plane_index(self, z: int, c: int, t: int) -> int:
        """Page of (z, c, t) for the XYxxx dimension orders."""
        m = self.meta
        s = self._channels_per_plane
        dims = {"Z": (z, m.size_z), "C": (c // s, max(1, m.size_c // s)),
                "T": (t, m.size_t)}
        idx, stride = 0, 1
        for d in self.dim_order[2:]:
            val, size = dims[d]
            idx += val * stride
            stride *= size
        return idx

    @property
    def resolution_levels(self) -> int:
        return 1 + len(self.ifds[0].sub_ifds)

    def level_size(self, level: int = 0) -> Tuple[int, int]:
        ifd = self.ifds[0] if level == 0 else self.ifds[0].sub_ifds[level - 1]
        return ifd.width, ifd.height

    def _reader_for(self, z, c, t, x, y, w, h, level) -> _LevelReader:
        m = self.meta
        if not 0 <= level < self.resolution_levels:
            raise ValueError(
                f"Resolution level {level} out of range [0, {self.resolution_levels})"
            )
        sx, sy = self.level_size(level)
        check_bounds(z, c, t, x, y, w, h, sx, sy, m.size_z, m.size_c, m.size_t)
        main = self.ifds[self._plane_index(z, c, t)]
        ifd = main if level == 0 else main.sub_ifds[level - 1]
        return _LevelReader(self.mm, self.bo, ifd, self._dtype, self.samples,
                            self.block_cache, self.cache_ns, self.device_idct)

    def _extract_channel(self, region: np.ndarray, c: int) -> np.ndarray:
        if self._channels_per_plane > 1 and region.ndim == 3:
            return np.ascontiguousarray(region[:, :, c % self._channels_per_plane])
        return region

    def get_tile_at(self, level, z, c, t, x, y, w, h) -> np.ndarray:
        reader = self._reader_for(z, c, t, x, y, w, h, level)
        return self._extract_channel(reader.read_region(x, y, w, h), c)

    def read_tiles(self, coords, level: int = 0):
        """Batched read: every compressed block the regions touch, across
        tiles and planes, is deduplicated and decoded once (zlib, LZW and
        PackBits in one native call; JPEG and zstd in Python; every codec
        in Python on a thread pool without the native engine), then the
        regions assemble from the decoded blocks, once per (page, rect),
        shared by the channel lanes of an interleaved page. A lane whose
        block is corrupt is None."""
        from ..runtime.native import get_engine

        readers = [self._reader_for(z, c, t, x, y, w, h, level)
                   for (z, c, t, x, y, w, h) in coords]
        regions: Dict[tuple, np.ndarray] = {}

        def assemble(r, c, x, y, w, h, get_block=None):
            rk = (id(r.ifd), x, y, w, h)
            region = regions.get(rk)
            if region is None:
                region = regions[rk] = r.read_region(x, y, w, h, get_block=get_block)
            return self._extract_channel(region, c)

        if not any(r.compressed for r in readers):
            return [assemble(r, c, x, y, w, h)
                    for r, (_, c, _, x, y, w, h) in zip(readers, coords)]

        # plan: dedup compressed blocks across the batch, serving decoded
        # blocks from the block cache
        blocks: Dict[tuple, np.ndarray] = {}
        spans: Dict[tuple, Tuple[int, int, int, _LevelReader]] = {}
        for r, (_, _, _, x, y, w, h) in zip(readers, coords):
            if not r.compressed:
                continue
            for bi in r.plan_region(x, y, w, h):
                key = r.block_key(bi)
                if key in blocks or key in spans:
                    continue
                hit = self.block_cache.get(key)
                if hit is not None:
                    blocks[key] = hit
                else:
                    off, cnt, cap = r.block_span(bi)
                    spans[key] = (off, cnt, cap, r)

        engine = get_engine()
        if engine is not None and not engine.has_decode_batch:
            engine = None  # a library older than ABI v3: decode in Python
        native = [k for k, s in spans.items()
                  if engine is not None and s[3].compression not in _PYTHON_SIDE_CODECS]
        if native:
            decoded = engine.decode_batch(
                [bytes(self.mm[spans[k][0]: spans[k][0] + spans[k][1]]) for k in native],
                [spans[k][2] for k in native], [spans[k][3].compression for k in native])
            for key, arr in zip(native, decoded):
                if arr is not None:  # a corrupt block fails only its lanes
                    blocks[key] = spans[key][3].postprocess(arr)
        native_set = set(native)
        rest = [k for k in spans if k not in native_set]

        def decode(key):
            off, cnt, cap, r = spans[key]
            return r.decode_span(self.mm[off: off + cnt], cap)

        if engine is None and len(rest) >= _PARALLEL_BLOCKS:
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, len(rest)), thread_name_prefix="inflate"
            ) as pool:
                decoded = list(pool.map(decode, rest))
        else:
            decoded = [decode(k) for k in rest]
        for key, arr in zip(rest, decoded):
            if arr is not None:
                blocks[key] = arr
        for key in spans:
            if key in blocks:
                self.block_cache.put(key, blocks[key])

        out: List[Optional[np.ndarray]] = []
        for r, (_, c, _, x, y, w, h) in zip(readers, coords):
            get_block = (lambda i, _r=r: blocks[_r.block_key(i)]) if r.compressed else None
            try:
                out.append(assemble(r, c, x, y, w, h, get_block=get_block))
            except KeyError:  # a block it needs failed to decode
                out.append(None)
        return out

    def close(self) -> None:
        mm = getattr(self, "mm", None)
        if mm is not None:
            mm.close()
        self._file.close()


def write_ome_tiff(
    path: str,
    data: np.ndarray,
    tile_size: Optional[Tuple[int, int]] = (256, 256),
    pyramid_levels: int = 1,
    compression: Optional[str] = None,  # None|zlib|lzw|packbits|jpeg|zstd
    big_endian: bool = True,
    bigtiff: bool = False,
    predictor: int = 1,  # 2 = horizontal differencing (zlib/lzw/zstd)
    jpeg_quality: int = 90,
    jpeg_subsampling: int = 0,  # 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0
    ome_xml: bool = True,
) -> None:
    """Write 5D TCZYX (or 6D TCZYXS for RGB, S = 3) data as a (pyramidal)
    OME-TIFF: planes in XYCZT page order, pyramid levels as SubIFDs,
    tiled (``tile_size``) or one strip per plane (``tile_size=None``);
    ``bigtiff`` emits the 64-bit-offset layout (magic 43). With
    ``ome_xml`` (the default) the bytes equal the JAX package's writer's;
    ``ome_xml=False`` leaves out the ImageDescription, as a scanner's
    TIFF does (a 6D image then reads as (h, w, 3) RGB tiles). The file is
    assembled in memory."""
    if data.ndim == 6:
        if data.shape[5] != 3:
            raise TiffError("6D input must be TCZYXS with S=3 (RGB)")
    elif data.ndim != 5:
        raise TiffError("write_ome_tiff expects TCZYX(S) data")
    T, C, Z, Y, X = data.shape[:5]
    bo = ">" if big_endian else "<"
    dtype = data.dtype
    comp_code = {None: 1, "zlib": 8, "lzw": 5, "packbits": 32773, "jpeg": 7,
                 "zstd": 50000}[compression]
    if predictor not in (1, 2):
        raise TiffError(f"Unsupported predictor: {predictor}")
    if predictor == 2 and comp_code in (1, 7, 32773):
        raise TiffError("predictor 2 requires zlib, lzw, or zstd compression")
    if comp_code == 7 and dtype != np.dtype(np.uint8):
        raise TiffError("JPEG compression requires uint8 samples")
    # JPEG tile streams ship abbreviated: the tables go once into tag
    # 347 (all tiles share one table set: quality and subsampling are
    # constant)
    jpeg_state: Dict[str, Optional[bytes]] = {"tables": None}
    kind_fmt = {"u": 1, "i": 2, "f": 3}[dtype.kind]
    samples = 3 if data.ndim == 6 else 1
    ome = (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06">'
        '<Image ID="Image:0">'
        f'<Pixels ID="Pixels:0" DimensionOrder="XYCZT" '
        f'Type="{omero_type_for(dtype)}" '
        f'SizeX="{X}" SizeY="{Y}" SizeZ="{Z}" '
        f'SizeC="{C * samples}" SizeT="{T}" '
        f'BigEndian="{"true" if big_endian else "false"}">'
        + "".join(f'<Channel ID="Channel:0:{c}" SamplesPerPixel="{samples}"/>'
                  for c in range(C))
        + "<TiffData/></Pixels></Image></OME>"
    ) if ome_xml else None
    fl = _TIFF_FLAVORS[bigtiff]
    buf = bytearray()
    if bigtiff:
        buf += b"MM\x00+" if big_endian else b"II+\x00"
        buf += struct.pack(bo + "HH", 8, 0) + b"\x00" * 8  # IFD 0 pointer at 8
    else:
        buf += (b"MM\x00*" if big_endian else b"II*\x00") + b"\x00" * 4

    def pack(fmt, *vals):
        return struct.pack(bo + fmt, *vals)

    def encode_block(raw: bytes, row_samples: int, nsamples: int) -> bytes:
        if comp_code == 7:
            from io import BytesIO

            from PIL import Image

            from .jpeg import split_tables

            pixels = np.frombuffer(raw, np.uint8).reshape(-1, row_samples // nsamples, nsamples)
            img = Image.fromarray(pixels if nsamples == 3 else pixels[:, :, 0],
                                  "RGB" if nsamples == 3 else "L")
            out = BytesIO()
            img.save(out, "JPEG", quality=jpeg_quality,
                     subsampling=jpeg_subsampling if nsamples == 3 else -1)
            tables, stripped = split_tables(out.getvalue())
            if jpeg_state["tables"] is None:
                jpeg_state["tables"] = tables
            return stripped
        if predictor == 2:
            raw = _codecs.apply_predictor2(np.frombuffer(raw, dtype=np.uint8), row_samples,
                                           dtype.itemsize, nsamples, bo).tobytes()
        if comp_code == 8:
            return zlib.compress(raw, 1)
        if comp_code == 5:
            return _codecs.lzw_encode(raw)
        if comp_code == 50000:
            import zstandard

            return zstandard.ZstdCompressor(level=3).compress(raw)
        if comp_code == 32773:
            return _codecs.packbits_encode(raw, row_samples * dtype.itemsize)
        return raw

    def write_blocks(plane: np.ndarray):
        """Tiles (or one strip) of a 2D/3D plane -> (offsets, counts)."""
        be = np.ascontiguousarray(plane.astype(dtype.newbyteorder(bo), copy=False))
        nsamples = plane.shape[2] if plane.ndim == 3 else 1
        offsets, counts = [], []
        if tile_size:
            tw, th = tile_size
            for ty in range(0, plane.shape[0], th):
                for tx in range(0, plane.shape[1], tw):
                    block = np.zeros((th, tw) + plane.shape[2:], dtype=dtype.newbyteorder(bo))
                    sub = be[ty: ty + th, tx: tx + tw]
                    block[: sub.shape[0], : sub.shape[1]] = sub
                    raw = encode_block(block.tobytes(), tw * nsamples, nsamples)
                    offsets.append(len(buf))
                    counts.append(len(raw))
                    buf.extend(raw)
                    if len(raw) % 2:
                        buf.extend(b"\x00")
        else:
            raw = encode_block(be.tobytes(), plane.shape[1] * nsamples, nsamples)
            offsets.append(len(buf))
            counts.append(len(raw))
            buf.extend(raw)
        return offsets, counts

    def build_ifd(plane: np.ndarray, description=None, subs=None) -> int:
        """Pixel data + IFD of one plane image; returns the IFD offset
        (chained afterwards)."""
        h, w = plane.shape[:2]
        nsamples = plane.shape[2] if plane.ndim == 3 else 1
        offsets, counts = write_blocks(plane)
        entries = [  # (tag, type, count, values | bytes)
            (_T["WIDTH"], 4, 1, [w]), (_T["LENGTH"], 4, 1, [h]),
            (_T["BITS"], 3, nsamples, [dtype.itemsize * 8] * nsamples),
            (_T["COMPRESSION"], 3, 1, [comp_code]),
        ]
        if predictor == 2:
            entries.append((_T["PREDICTOR"], 3, 1, [2]))
        if comp_code == 7:
            # 6 = YCbCr (the encoder's colour space) for RGB
            entries.append((_T["PHOTOMETRIC"], 3, 1, [6 if nsamples == 3 else 1]))
            if jpeg_state["tables"]:
                tbl = jpeg_state["tables"]
                entries.append((_T["JPEG_TABLES"], 7, len(tbl), tbl))
        else:
            entries.append((_T["PHOTOMETRIC"], 3, 1, [2 if nsamples == 3 else 1]))
        if description:
            entries.append((_T["DESCRIPTION"], 2, len(description) + 1,
                            description.encode() + b"\x00"))
        if tile_size:
            entries += [
                (_T["TILE_WIDTH"], 3, 1, [tile_size[0]]),
                (_T["TILE_LENGTH"], 3, 1, [tile_size[1]]),
                (_T["TILE_OFFSETS"], fl.off_typ, len(offsets), offsets),
                (_T["TILE_COUNTS"], fl.off_typ, len(counts), counts),
            ]
        else:
            entries += [
                (_T["STRIP_OFFSETS"], fl.off_typ, len(offsets), offsets),
                (_T["ROWS_PER_STRIP"], 4, 1, [h]),
                (_T["STRIP_COUNTS"], fl.off_typ, len(counts), counts),
            ]
        entries.append((_T["SAMPLES"], 3, 1, [nsamples]))
        entries.append((_T["SAMPLE_FORMAT"], 3, nsamples, [kind_fmt] * nsamples))
        if subs:
            entries.append((_T["SUB_IFDS"], fl.off_typ, len(subs), subs))
        entries.sort(key=lambda e: e[0])
        fields = []  # out-of-line values first
        for _tag, typ, _count, values in entries:
            raw = values if typ in (2, 7) else b"".join(
                pack(_TYPE_FMT[typ], v) for v in values)
            if len(raw) <= fl.inline:
                fields.append(raw + b"\x00" * (fl.inline - len(raw)))
            else:
                if len(buf) % 2:
                    buf.extend(b"\x00")
                fields.append(pack(fl.off_fmt, len(buf)))
                buf.extend(raw)
        if len(buf) % 2:
            buf.extend(b"\x00")
        ifd_off = len(buf)
        buf.extend(pack(fl.cnt_fmt, len(entries)))
        for (tag, typ, count, _), field in zip(entries, fields):
            buf.extend(pack("HH", tag, typ) + pack(fl.off_fmt, count) + field)
        buf.extend(pack(fl.off_fmt, 0))  # next pointer, patched below
        return ifd_off

    main_offsets = []
    for t in range(T):
        for z in range(Z):
            for c in range(C):  # XYCZT: C fastest
                plane = data[t, c, z]
                subs = []
                level = plane
                for _ in range(1, pyramid_levels):
                    level = level[::2, ::2]
                    subs.append(build_ifd(level))
                main_offsets.append(build_ifd(
                    plane, description=ome if not main_offsets else None,
                    subs=subs or None))
    struct.pack_into(bo + fl.off_fmt, buf, 8 if bigtiff else 4, main_offsets[0])
    for prev, nxt in zip(main_offsets, main_offsets[1:]):
        (n,) = struct.unpack_from(bo + fl.cnt_fmt, buf, prev)
        struct.pack_into(bo + fl.off_fmt, buf, prev + fl.cnt_len + fl.entry_len * n, nxt)
    with open(path, "wb") as f:
        f.write(buf)
