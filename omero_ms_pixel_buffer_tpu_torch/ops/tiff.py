"""TIFF / OME-TIFF encoding.

Replaces the reference's Bio-Formats ``ImageWriter`` TIFF path
(TileRequestHandler.java:176-199 via loci.formats.out.TiffWriter): one
tile -> one single-plane big-endian baseline TIFF whose ImageDescription
carries the same minimal OME-XML the reference synthesizes in
``createMetadata`` (TileRequestHandler.java:145-170: Image:0/Pixels:0/
Channel:0:0, SamplesPerPixel 1, BigEndian true, SizeZ/C/T=1,
DimensionOrder XYCZT, pixel type from the source).

TIFF framing is a few hundred bytes of header around the raw big-endian
pixel strip — pure host-side byte assembly; the pixel bytes themselves
come straight from the device pipeline's big-endian output, so the TIFF
path adds no per-pixel host work.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259  # 1 = none, 8 = zlib/deflate
_PHOTOMETRIC = 262  # 1 = BlackIsZero, 2 = RGB
_IMAGE_DESCRIPTION = 270
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_SAMPLE_FORMAT = 339  # 1 = unsigned, 2 = signed, 3 = float

_TYPE_SHORT, _TYPE_LONG, _TYPE_ASCII = 3, 4, 2


class TiffEncodeError(ValueError):
    """Unsupported input for TIFF — surfaces as encode-failure -> 404."""


def _sample_format(dtype: np.dtype) -> int:
    if dtype.kind == "u":
        return 1
    if dtype.kind == "i":
        return 2
    if dtype.kind == "f":
        return 3
    raise TiffEncodeError(f"Unsupported TIFF pixel type: {dtype}")


def ome_xml_metadata(
    width: int, height: int, pixels_type: str, samples_per_pixel: int = 1
) -> str:
    """Minimal single-plane OME-XML mirroring the reference's
    createMetadata field-for-field (TileRequestHandler.java:145-170)."""
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06">'
        '<Image ID="Image:0">'
        f'<Pixels ID="Pixels:0" DimensionOrder="XYCZT" Type="{pixels_type}" '
        f'SizeX="{width}" SizeY="{height}" SizeZ="1" SizeC="1" SizeT="1" '
        'BigEndian="true">'
        f'<Channel ID="Channel:0:0" SamplesPerPixel="{samples_per_pixel}"/>'
        "<TiffData/>"
        "</Pixels></Image></OME>"
    )


def encode_tiff(
    tile: np.ndarray,
    pixels_type: Optional[str] = None,
    description: Optional[str] = None,
) -> bytes:
    """Encode a (H, W) or (H, W, 3) array as a big-endian ("MM") baseline
    TIFF with one strip of uncompressed big-endian pixel data.

    ``description`` defaults to the reference-parity OME-XML; pass "" to
    omit the tag entirely.
    """
    if tile.ndim == 2:
        samples, photometric = 1, 1
    elif tile.ndim == 3 and tile.shape[2] == 3:
        samples, photometric = 3, 2
    else:
        raise TiffEncodeError(f"Unsupported TIFF shape: {tile.shape}")
    dtype = tile.dtype
    sample_format = _sample_format(dtype)
    h, w = tile.shape[:2]
    bits = dtype.itemsize * 8
    if pixels_type is None:
        from .convert import omero_type_for

        pixels_type = omero_type_for(dtype)
    if description is None:
        description = ome_xml_metadata(w, h, pixels_type, samples)
    desc_bytes = description.encode("utf-8") + b"\x00" if description else b""

    strip = np.ascontiguousarray(
        tile.astype(dtype.newbyteorder(">"), copy=False)
    ).tobytes()

    # Layout: header(8) | IFD | [bits array] | [description] | strip
    entries = []  # (tag, type, count, value_or_bytes, is_offset)

    def entry(tag, typ, count, value):
        entries.append((tag, typ, count, value))

    entry(_IMAGE_WIDTH, _TYPE_LONG, 1, w)
    entry(_IMAGE_LENGTH, _TYPE_LONG, 1, h)
    entry(_BITS_PER_SAMPLE, _TYPE_SHORT, samples, [bits] * samples)
    entry(_COMPRESSION, _TYPE_SHORT, 1, 1)
    entry(_PHOTOMETRIC, _TYPE_SHORT, 1, photometric)
    if desc_bytes:
        entry(_IMAGE_DESCRIPTION, _TYPE_ASCII, len(desc_bytes), desc_bytes)
    entry(_STRIP_OFFSETS, _TYPE_LONG, 1, None)  # patched below
    entry(_SAMPLES_PER_PIXEL, _TYPE_SHORT, 1, samples)
    entry(_ROWS_PER_STRIP, _TYPE_LONG, 1, h)
    entry(_STRIP_BYTE_COUNTS, _TYPE_LONG, 1, len(strip))
    entry(_SAMPLE_FORMAT, _TYPE_SHORT, samples, [sample_format] * samples)
    entries.sort(key=lambda e: e[0])

    ifd_offset = 8
    ifd_size = 2 + 12 * len(entries) + 4
    extra_offset = ifd_offset + ifd_size
    extra = b""

    def _value_field(typ, count, value):
        nonlocal extra
        if typ == _TYPE_ASCII:
            data = value
        elif typ == _TYPE_SHORT:
            vals = value if isinstance(value, list) else [value]
            data = b"".join(struct.pack(">H", v) for v in vals)
        else:
            vals = value if isinstance(value, list) else [value]
            data = b"".join(struct.pack(">I", v) for v in vals)
        if len(data) <= 4:
            return data + b"\x00" * (4 - len(data))
        off = extra_offset + len(extra)
        extra += data + (b"\x00" if len(data) % 2 else b"")
        return struct.pack(">I", off)

    # First pass for all entries except strip offset (needs final layout).
    fields = []
    for tag, typ, count, value in entries:
        if tag == _STRIP_OFFSETS:
            fields.append(None)
            continue
        fields.append(_value_field(typ, count, value))
    strip_offset = extra_offset + len(extra)
    fields = [
        f if f is not None else struct.pack(">I", strip_offset) for f in fields
    ]

    out = bytearray()
    out += b"MM\x00*" + struct.pack(">I", ifd_offset)
    out += struct.pack(">H", len(entries))
    for (tag, typ, count, _), field in zip(entries, fields):
        out += struct.pack(">HHI", tag, typ, count) + field
    out += struct.pack(">I", 0)  # next IFD offset
    out += extra
    out += strip
    return bytes(out)


def decode_tiff(data: bytes) -> np.ndarray:
    """Minimal big/little-endian baseline TIFF decoder for tests (single
    strip or contiguous strips, uncompressed)."""
    bo = {b"II": "<", b"MM": ">"}[data[:2]]
    (ifd_off,) = struct.unpack(bo + "I", data[4:8])
    (n,) = struct.unpack(bo + "H", data[ifd_off : ifd_off + 2])
    tags = {}
    for i in range(n):
        off = ifd_off + 2 + 12 * i
        tag, typ, count = struct.unpack(bo + "HHI", data[off : off + 8])
        raw = data[off + 8 : off + 12]
        size = {_TYPE_SHORT: 2, _TYPE_LONG: 4, _TYPE_ASCII: 1}[typ] * count
        if size > 4:
            (ptr,) = struct.unpack(bo + "I", raw)
            raw = data[ptr : ptr + size]
        else:
            raw = raw[:size]
        if typ == _TYPE_SHORT:
            vals = list(struct.unpack(bo + "H" * count, raw))
        elif typ == _TYPE_LONG:
            vals = list(struct.unpack(bo + "I" * count, raw))
        else:
            vals = raw
        tags[tag] = vals
    w, h = tags[_IMAGE_WIDTH][0], tags[_IMAGE_LENGTH][0]
    bits = tags[_BITS_PER_SAMPLE][0]
    samples = tags.get(_SAMPLES_PER_PIXEL, [1])[0]
    fmt = tags.get(_SAMPLE_FORMAT, [1])[0]
    kind = {1: "u", 2: "i", 3: "f"}[fmt]
    dt = np.dtype(f"{bo}{kind}{bits // 8}")
    strip = b"".join(
        data[o : o + c]
        for o, c in zip(tags[_STRIP_OFFSETS], tags[_STRIP_BYTE_COUNTS])
    )
    arr = np.frombuffer(strip, dtype=dt)
    shape = (h, w, samples) if samples > 1 else (h, w)
    return arr.reshape(shape).astype(dt.newbyteorder("="))
