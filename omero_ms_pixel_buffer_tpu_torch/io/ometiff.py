"""OME-TIFF pixel buffer, reader and writer (counterpart of
``omero_ms_pixel_buffer_tpu/io/ometiff.py``, limited to what this slice
serves): classic or BigTIFF, planes in XYCZT page order, pyramid levels
in SubIFDs, tiled storage, compression none or zlib, 8- or 16-bit
integer samples, one sample per pixel.
"""

from __future__ import annotations

import collections
import concurrent.futures
import mmap
import os
import re
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.convert import dtype_for, omero_type_for
from .pixel_buffer import BlockCache, PixelBuffer, PixelsMeta, check_bounds

_T = {"WIDTH": 256, "LENGTH": 257, "BITS": 258, "COMPRESSION": 259,
      "PHOTOMETRIC": 262, "DESCRIPTION": 270, "SAMPLES": 277,
      "PREDICTOR": 317, "TILE_WIDTH": 322, "TILE_LENGTH": 323,
      "TILE_OFFSETS": 324, "TILE_COUNTS": 325, "SUB_IFDS": 330,
      "SAMPLE_FORMAT": 339}

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

# decode blocks on a thread pool when a batch needs at least this many
# (zlib releases the GIL while inflating)
_PARALLEL_BLOCKS = 4


class TiffError(ValueError):
    pass


class _Ifd:
    """One parsed IFD: tag dict (+ ``sub_ifds`` for pyramid levels)."""

    def __init__(self, tags: Dict[int, list]):
        self.tags = tags
        self.sub_ifds: List["_Ifd"] = []

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


def _parse_ifds(data) -> Tuple[str, List[_Ifd]]:
    """Parse the main IFD chain plus SubIFD chains."""
    if data[:2] == b"II":
        bo = "<"
    elif data[:2] == b"MM":
        bo = ">"
    else:
        raise TiffError("Not a TIFF file")
    try:
        return bo, _parse_chain(data, bo)
    except (struct.error, IndexError, OverflowError) as e:
        raise TiffError(f"Corrupt TIFF structure: {e}") from None


def _parse_chain(data, bo: str) -> List[_Ifd]:
    (magic,) = struct.unpack(bo + "H", data[2:4])
    if magic == 42:
        big = False
        (first_off,) = struct.unpack(bo + "I", data[4:8])
    elif magic == 43:
        big = True
        (first_off,) = struct.unpack(bo + "Q", data[8:16])
    else:
        raise TiffError(f"Unknown TIFF magic: {magic}")
    fl = _TIFF_FLAVORS[big]

    def parse_one(off: int) -> Tuple[_Ifd, int]:
        (n,) = struct.unpack(bo + fl.cnt_fmt, data[off: off + fl.cnt_len])
        if n > 65536:
            raise TiffError(f"IFD claims {n} entries")
        tags: Dict[int, list] = {}
        for i in range(n):
            eo = off + fl.cnt_len + fl.entry_len * i
            tag, typ = struct.unpack(bo + "HH", data[eo: eo + 4])
            (count,) = struct.unpack(
                bo + fl.off_fmt, data[eo + 4: eo + 4 + fl.inline]
            )
            size = _TYPE_SIZES.get(typ, 1) * count
            if size > len(data):
                raise TiffError(f"Tag {tag} claims {size} value bytes")
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


class _LevelReader:
    """Tile access within one IFD (one plane at one level)."""

    def __init__(self, mm, bo: str, ifd: _Ifd, dtype: np.dtype,
                 cache: BlockCache, cache_ns: int):
        if _T["TILE_OFFSETS"] not in ifd.tags:
            raise TiffError("Only tiled TIFF storage is supported")
        self.mm = mm
        self.ifd = ifd
        self.dtype = dtype.newbyteorder(bo)
        self.cache = cache
        self.cache_ns = cache_ns
        self.compression = ifd.first("COMPRESSION", 1)
        if self.compression not in (1, 8):
            raise TiffError(f"Unsupported compression: {self.compression}")
        if ifd.first("PREDICTOR", 1) != 1:
            raise TiffError("Unsupported predictor")
        self.tw, self.th = ifd.first("TILE_WIDTH"), ifd.first("TILE_LENGTH")

    def block_key(self, i: int) -> tuple:
        return (self.cache_ns, id(self.ifd), i)

    def plan_region(self, x: int, y: int, w: int, h: int) -> List[int]:
        """Indices of the on-disk tiles the region touches."""
        across = (self.ifd.width + self.tw - 1) // self.tw
        return [
            ty * across + tx
            for ty in range(y // self.th, (y + h - 1) // self.th + 1)
            for tx in range(x // self.tw, (x + w - 1) // self.tw + 1)
        ]

    def decode_block(self, i: int) -> np.ndarray:
        """One tile's raw bytes, inflated (bounded at the tile size)."""
        cap = self.th * self.tw * self.dtype.itemsize
        off = self.ifd.values("TILE_OFFSETS")[i]
        cnt = self.ifd.values("TILE_COUNTS")[i]
        raw = self.mm[off: off + cnt]
        if self.compression == 1:
            return np.frombuffer(raw, dtype=np.uint8)[:cap]
        d = zlib.decompressobj()
        plain = d.decompress(raw, cap)
        if len(plain) != cap:
            raise TiffError(f"Corrupt block {i}")
        return np.frombuffer(plain, dtype=np.uint8)

    def block(self, i: int) -> np.ndarray:
        key = self.block_key(i)
        hit = self.cache.get(key)
        if hit is None:
            hit = self.decode_block(i)
            if self.compression != 1:
                self.cache.put(key, hit)
        return hit

    def read_region(self, x: int, y: int, w: int, h: int, get_block=None) -> np.ndarray:
        get_block = get_block or self.block
        W, H = self.ifd.width, self.ifd.height
        tw, th = self.tw, self.th
        across = (W + tw - 1) // tw
        out = np.zeros((h, w), dtype=self.dtype.newbyteorder("="))
        for ty in range(y // th, (y + h - 1) // th + 1):
            for tx in range(x // tw, (x + w - 1) // tw + 1):
                tile = np.frombuffer(get_block(ty * across + tx), dtype=self.dtype)
                tile = tile[: th * tw].reshape(th, tw)
                y0, x0 = ty * th, tx * tw
                lo_y, hi_y = max(y, y0), min(y + h, y0 + th, H)
                lo_x, hi_x = max(x, x0), min(x + w, x0 + tw, W)
                if hi_y <= lo_y or hi_x <= lo_x:
                    continue
                out[lo_y - y: hi_y - y, lo_x - x: hi_x - x] = tile[
                    lo_y - y0: hi_y - y0, lo_x - x0: hi_x - x0
                ]
        return out


class OmeTiffPixelBuffer(PixelBuffer):
    """OME-TIFF (optionally pyramidal) as a PixelBuffer."""

    def __init__(self, path: str, image_id: int = 0, image_name: str = "",
                 block_cache: Optional[BlockCache] = None):
        self.path = path
        self.block_cache = block_cache if block_cache is not None else BlockCache()
        self._file = open(path, "rb")
        try:
            self.mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
            self.bo, self.ifds = _parse_ifds(self.mm)
            self._init_meta(image_id, image_name)
        except BaseException:
            self.close()
            raise

    def _init_meta(self, image_id: int, image_name: str) -> None:
        if not self.ifds:
            raise TiffError(f"No IFDs in {self.path}")
        first = self.ifds[0]
        if first.first("SAMPLES", 1) != 1:
            raise TiffError("Only one sample per pixel is supported")
        bits = first.first("BITS", 8)
        kind = {1: "u", 2: "i"}.get(first.first("SAMPLE_FORMAT", 1))
        if kind is None or bits not in (8, 16):
            raise TiffError("Only 8- or 16-bit integer samples are supported")
        ome = _parse_ome(first.first("DESCRIPTION", "") or "") or {}
        ptype = ome.get("Type") or omero_type_for(np.dtype(f"{kind}{bits // 8}"))
        sz, sc, st = (int(ome.get(k, 1)) for k in ("SizeZ", "SizeC", "SizeT"))
        if sz * sc * st > len(self.ifds):
            sz, sc, st = 1, 1, len(self.ifds)  # metadata lies: page count
        self.dim_order = ome.get("DimensionOrder", "XYCZT")
        super().__init__(PixelsMeta(
            image_id=image_id, size_x=first.width, size_y=first.height,
            size_z=sz, size_c=sc, size_t=st, pixels_type=ptype,
            image_name=image_name or os.path.basename(self.path),
        ))
        self._dtype = dtype_for(ptype)

    def _plane_index(self, z: int, c: int, t: int) -> int:
        m = self.meta
        dims = {"Z": (z, m.size_z), "C": (c, m.size_c), "T": (t, m.size_t)}
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
        return _LevelReader(self.mm, self.bo, ifd, self._dtype,
                            self.block_cache, self.cache_ns)

    def get_tile_at(self, level, z, c, t, x, y, w, h) -> np.ndarray:
        return self._reader_for(z, c, t, x, y, w, h, level).read_region(x, y, w, h)

    def read_tiles(self, coords, level: int = 0):
        """Batched read: every compressed tile the requested regions
        touch is deduplicated and inflated once (in parallel when there
        are several), then the regions assemble from decoded tiles."""
        readers = [self._reader_for(z, c, t, x, y, w, h, level)
                   for (z, c, t, x, y, w, h) in coords]
        blocks: Dict[tuple, np.ndarray] = {}
        todo: Dict[tuple, Tuple[_LevelReader, int]] = {}
        for r, (_, _, _, x, y, w, h) in zip(readers, coords):
            for i in r.plan_region(x, y, w, h):
                key = r.block_key(i)
                if key in blocks or key in todo:
                    continue
                hit = r.cache.get(key) if r.compression != 1 else None
                if hit is not None:
                    blocks[key] = hit
                else:
                    todo[key] = (r, i)
        if len(todo) >= _PARALLEL_BLOCKS:
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, len(todo)), thread_name_prefix="inflate"
            ) as pool:
                decoded = list(pool.map(lambda ri: ri[0].decode_block(ri[1]),
                                        todo.values()))
        else:
            decoded = [r.decode_block(i) for r, i in todo.values()]
        for (key, (r, _)), arr in zip(todo.items(), decoded):
            blocks[key] = arr
            if r.compression != 1:
                r.cache.put(key, arr)
        return [
            r.read_region(x, y, w, h,
                          get_block=lambda i, _r=r: blocks[_r.block_key(i)])
            for r, (_, _, _, x, y, w, h) in zip(readers, coords)
        ]

    def close(self) -> None:
        mm = getattr(self, "mm", None)
        if mm is not None:
            mm.close()
        self._file.close()


def write_ome_tiff(
    path: str,
    data: np.ndarray,
    tile_size: Tuple[int, int] = (256, 256),
    pyramid_levels: int = 1,
    compression: Optional[str] = None,  # None | "zlib"
    big_endian: bool = True,
) -> None:
    """Write 5D TCZYX 8/16-bit integer data as a tiled (pyramidal)
    classic OME-TIFF: planes in XYCZT page order, pyramid levels as
    SubIFDs (2x subsampled). The file is assembled in memory."""
    if data.ndim != 5:
        raise TiffError("write_ome_tiff expects TCZYX data")
    if data.dtype.kind not in "ui" or data.dtype.itemsize not in (1, 2):
        raise TiffError(f"Unsupported dtype: {data.dtype}")
    comp_code = {None: 1, "zlib": 8}[compression]
    T, C, Z, Y, X = data.shape
    bo = ">" if big_endian else "<"
    dtype = data.dtype
    kind_fmt = {"u": 1, "i": 2}[dtype.kind]
    ome = (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06">'
        '<Image ID="Image:0">'
        f'<Pixels ID="Pixels:0" DimensionOrder="XYCZT" '
        f'Type="{omero_type_for(dtype)}" '
        f'SizeX="{X}" SizeY="{Y}" SizeZ="{Z}" SizeC="{C}" SizeT="{T}" '
        f'BigEndian="{"true" if big_endian else "false"}">'
        + "".join(f'<Channel ID="Channel:0:{c}" SamplesPerPixel="1"/>'
                  for c in range(C))
        + "<TiffData/></Pixels></Image></OME>"
    )
    fl = _TIFF_FLAVORS[False]
    buf = bytearray((b"MM\x00*" if big_endian else b"II*\x00") + b"\x00" * 4)
    tw, th = tile_size

    def pack(fmt, *vals):
        return struct.pack(bo + fmt, *vals)

    def build_ifd(plane: np.ndarray, description=None, subs=None) -> int:
        h, w = plane.shape
        be = np.ascontiguousarray(plane.astype(dtype.newbyteorder(bo), copy=False))
        offsets, counts = [], []
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                block = np.zeros((th, tw), dtype=dtype.newbyteorder(bo))
                sub = be[ty: ty + th, tx: tx + tw]
                block[: sub.shape[0], : sub.shape[1]] = sub
                raw = block.tobytes()
                if comp_code == 8:
                    raw = zlib.compress(raw, 1)
                offsets.append(len(buf))
                counts.append(len(raw))
                buf.extend(raw)
                if len(raw) % 2:
                    buf.extend(b"\x00")
        entries = [
            (_T["WIDTH"], 4, 1, [w]), (_T["LENGTH"], 4, 1, [h]),
            (_T["BITS"], 3, 1, [dtype.itemsize * 8]),
            (_T["COMPRESSION"], 3, 1, [comp_code]),
            (_T["PHOTOMETRIC"], 3, 1, [1]),
            (_T["SAMPLES"], 3, 1, [1]),
            (_T["TILE_WIDTH"], 3, 1, [tw]), (_T["TILE_LENGTH"], 3, 1, [th]),
            (_T["TILE_OFFSETS"], fl.off_typ, len(offsets), offsets),
            (_T["TILE_COUNTS"], fl.off_typ, len(counts), counts),
            (_T["SAMPLE_FORMAT"], 3, 1, [kind_fmt]),
        ]
        if description:
            entries.append((_T["DESCRIPTION"], 2, len(description) + 1,
                            description.encode() + b"\x00"))
        if subs:
            entries.append((_T["SUB_IFDS"], fl.off_typ, len(subs), subs))
        entries.sort(key=lambda e: e[0])
        fields = []
        for _tag, typ, _count, values in entries:
            raw = values if typ == 2 else b"".join(
                pack(_TYPE_FMT[typ], v) for v in values
            )
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
                    subs=subs or None,
                ))
    struct.pack_into(bo + fl.off_fmt, buf, 4, main_offsets[0])
    for prev, nxt in zip(main_offsets, main_offsets[1:]):
        (n,) = struct.unpack_from(bo + fl.cnt_fmt, buf, prev)
        struct.pack_into(bo + fl.off_fmt, buf, prev + fl.cnt_len + fl.entry_len * n, nxt)
    with open(path, "wb") as f:
        f.write(buf)
