"""The port's OME-NGFF/Zarr reader and writer (``io/zarr.py``) against the
JAX package's on the same inputs, made from a seed with numpy.
Tolerance: zero — written trees are compared file by file and byte for
byte, tiles value for value and dtype for dtype, and a corrupt chunk or
shard index must raise in both."""

import gzip
import json
import os
import shutil
import types

import numpy as np
import pytest

from conftest import needs_zstd

from omero_ms_pixel_buffer_tpu.io import zarr as jzarr
from omero_ms_pixel_buffer_tpu_torch.io import zarr as pzarr
from omero_ms_pixel_buffer_tpu_torch.io import pixel_buffer
from omero_ms_pixel_buffer_tpu_torch.io.pixel_buffer import BlockCache
from omero_ms_pixel_buffer_tpu_torch.runtime import native

COMPRESSORS = [None, "zlib", "gzip", "lz4", "blosc-lz4", "blosc-zlib",
               pytest.param("blosc-zstd", marks=needs_zstd),
               pytest.param("zstd", marks=needs_zstd)]
FORMATS = [(2, None), (3, None), (3, (64, 64))]  # v2, v3, v3 sharded


def _image(dtype, shape=(1, 2, 2, 100, 120), seed=67):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.normal(100, 40, shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(max(info.min, -30000), min(info.max, 60000), shape, dtype=dt)


@pytest.fixture
def fixed_gzip_time(monkeypatch):
    """gzip headers carry the write time: fix it so two writers' bytes compare."""
    monkeypatch.setattr(gzip, "time", types.SimpleNamespace(time=lambda: 1.7e9))


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _write_both(tmp_path, data, **kw):
    jroot, proot = str(tmp_path / "jax.zarr"), str(tmp_path / "port.zarr")
    jzarr.write_ngff(jroot, data, **kw)
    pzarr.write_ngff(proot, data, **kw)
    return jroot, proot


@pytest.mark.parametrize("compressor", COMPRESSORS)
@pytest.mark.parametrize("zarr_format,shards", FORMATS)
def test_write_ngff_tree_equals_jax(tmp_path, fixed_gzip_time, compressor, zarr_format, shards):
    data = _image(np.uint16)
    jroot, proot = _write_both(tmp_path, data, chunks=(32, 32), levels=2,
                               compressor=compressor, zarr_format=zarr_format, shards=shards)
    jt, pt = _tree(jroot), _tree(proot)
    assert sorted(jt) == sorted(pt)
    for key in jt:
        assert jt[key] == pt[key], key


# tiles: interior, across chunks, edge chunks (the 100x120 plane ends in
# partial chunks), the whole plane
COORDS = [(1, 1, 0, 5, 7, 60, 50), (0, 0, 0, 0, 0, 120, 100), (1, 0, 0, 90, 70, 30, 30),
          (0, 1, 0, 96, 64, 24, 36), (1, 1, 0, 31, 31, 2, 2)]


def _level_coords(level):
    s = 2 ** level
    return [(z, c, t, x // s, y // s, max(1, w // s), max(1, h // s))
            for z, c, t, x, y, w, h in COORDS]


def _read_both(jroot, proot, levels):
    jbuf, pbuf = jzarr.ZarrPixelBuffer(jroot), pzarr.ZarrPixelBuffer(proot)
    assert pbuf.meta.pixels_type == jbuf.meta.pixels_type
    assert pbuf.resolution_levels == jbuf.resolution_levels == levels
    for level in range(levels):
        assert pbuf.level_size(level) == jbuf.level_size(level)
        coords = _level_coords(level)
        got, want = pbuf.read_tiles(coords, level=level), jbuf.read_tiles(coords, level=level)
        for co, g, w in zip(coords, got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, co
            np.testing.assert_array_equal(g, w)
        # and the single-tile path, from a warm cache
        z, c, t, x, y, w_, h = coords[0]
        np.testing.assert_array_equal(pbuf.get_tile_at(level, z, c, t, x, y, w_, h), want[0])
    return jbuf, pbuf


@pytest.mark.parametrize("dtype", ["uint8", "int8", "uint16", "int16", "uint32", "float32"])
@pytest.mark.parametrize("zarr_format,shards", FORMATS)
def test_read_tiles_equal_jax_over_dtypes_and_levels(tmp_path, dtype, zarr_format, shards):
    data = _image(dtype)
    jroot, proot = _write_both(tmp_path, data, chunks=(32, 32), levels=3,
                               compressor="blosc-lz4", zarr_format=zarr_format, shards=shards)
    _, pbuf = _read_both(jroot, proot, 3)
    np.testing.assert_array_equal(pbuf.get_tile_at(0, 1, 1, 0, 0, 0, 120, 100), data[0, 1, 1])


@pytest.mark.parametrize("compressor", ["zlib", "lz4", "blosc-zlib"])
def test_absent_chunks_read_fill_value(tmp_path, compressor):
    data = _image(np.uint16)
    jroot, proot = _write_both(tmp_path, data, chunks=(32, 32), levels=1, compressor=compressor)
    for root in (jroot, proot):
        os.remove(os.path.join(root, "0", "0.1.0.1.1"))  # rows 32-63, cols 32-63 of z 0, c 1
        os.remove(os.path.join(root, "0", "0.0.1.3.3"))  # an edge chunk
    _, pbuf = _read_both(jroot, proot, 1)
    tile = pbuf.get_tile_at(0, 0, 1, 0, 0, 0, 120, 100)
    assert (tile[32:64, 32:64] == 0).all()
    np.testing.assert_array_equal(tile[:32], data[0, 1, 0, :32])


def test_absent_shard_and_sentinel_read_fill_value(tmp_path):
    data = _image(np.uint16)
    jroot, proot = _write_both(tmp_path, data, chunks=(32, 32), levels=1,
                               compressor="blosc-lz4", zarr_format=3, shards=(64, 64))
    for root in (jroot, proot):
        os.remove(os.path.join(root, "0", "c", "0", "0", "1", "1", "0"))  # z 1, rows 64-99
    _, pbuf = _read_both(jroot, proot, 1)
    assert (pbuf.get_tile_at(0, 1, 0, 0, 0, 64, 64, 36) == 0).all()


def test_negative_entries_expire(tmp_path, monkeypatch):
    data = _image(np.uint16)
    root = str(tmp_path / "img.zarr")
    pzarr.write_ngff(root, data, chunks=(32, 32), compressor="zlib")
    chunk = os.path.join(root, "0", "0.0.0.0.0")
    saved = open(chunk, "rb").read()
    os.remove(chunk)
    cache = BlockCache()
    buf = pzarr.ZarrPixelBuffer(root, block_cache=cache)
    assert (buf.get_tile_at(0, 0, 0, 0, 0, 0, 16, 16) == 0).all()
    with open(chunk, "wb") as f:
        f.write(saved)  # backfilled
    assert (buf.get_tile_at(0, 0, 0, 0, 0, 0, 16, 16) == 0).all()  # cached negative
    assert cache.purge_ns(buf.cache_ns) == 1
    monkeypatch.setattr(pixel_buffer, "NEGATIVE_TTL_S", 1e-9)
    os.remove(chunk)
    assert (buf.get_tile_at(0, 0, 0, 0, 0, 0, 16, 16) == 0).all()  # expires at once
    with open(chunk, "wb") as f:
        f.write(saved)
    np.testing.assert_array_equal(buf.get_tile_at(0, 0, 0, 0, 0, 0, 16, 16),
                                  data[0, 0, 0, :16, :16])


def _nest_v2(root):
    """Rewrite a v2 tree to ``dimension_separator: "/"`` (nested keys)."""
    for level in sorted(os.listdir(root)):
        ldir = os.path.join(root, level)
        if not os.path.isdir(ldir):
            continue
        meta_path = os.path.join(ldir, ".zarray")
        meta = json.load(open(meta_path))
        meta["dimension_separator"] = "/"
        json.dump(meta, open(meta_path, "w"))
        for name in os.listdir(ldir):
            if name.startswith("."):
                continue
            dst = os.path.join(ldir, *name.split("."))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.move(os.path.join(ldir, name), dst)


def test_slash_separator(tmp_path):
    data = _image(np.int16)
    jroot, proot = _write_both(tmp_path, data, chunks=(32, 32), levels=2, compressor="gzip")
    _nest_v2(jroot)
    _nest_v2(proot)
    _read_both(jroot, proot, 2)


def test_big_endian_v2_array(tmp_path):
    """A ``>u2`` v2 array: ``ZarrArray.read_region`` equals the JAX one
    (big-endian values); neither buffer maps the dtype (KeyError)."""
    data = _image(np.uint16).astype(">u2")
    jroot, proot = _write_both(tmp_path, data, chunks=(32, 32), levels=1, compressor="zlib")
    assert json.load(open(os.path.join(proot, "0", ".zarray")))["dtype"] == ">u2"
    jarr, parr = jzarr.ZarrArray(jroot, "0"), pzarr.ZarrArray(proot, "0")
    got = parr.read_region((0, 1, 1, 7, 9), (1, 1, 1, 70, 100))
    want = jarr.read_region((0, 1, 1, 7, 9), (1, 1, 1, 70, 100))
    assert got.dtype == want.dtype == np.dtype(">u2")
    np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError):
        jzarr.ZarrPixelBuffer(jroot)
    with pytest.raises(KeyError):
        pzarr.ZarrPixelBuffer(proot)


def _corrupt_last_byte(path):
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF
    open(path, "wb").write(bytes(raw))


@pytest.mark.parametrize("sharded", [False, True])
def test_crc32c_mismatch_raises_in_both(tmp_path, sharded):
    data = _image(np.uint16)
    jroot, proot = _write_both(tmp_path, data, chunks=(32, 32), levels=1, compressor="zlib",
                               zarr_format=3, shards=(64, 64) if sharded else None)
    for root in (jroot, proot):
        # unsharded: the chunk's checksum; sharded: the index footer's
        _corrupt_last_byte(os.path.join(root, "0", "c", "0", "0", "0", "0", "0"))
    coords = [(0, 0, 0, 0, 0, 48, 48)]
    with pytest.raises(jzarr.ZarrError, match="crc32c"):
        jzarr.ZarrPixelBuffer(jroot).read_tiles(coords)
    with pytest.raises(pzarr.ZarrError, match="crc32c"):
        pzarr.ZarrPixelBuffer(proot).read_tiles(coords)


@pytest.mark.parametrize("compressor", ["zlib", "blosc-lz4", "lz4"])
def test_corrupt_chunk_fails_the_whole_batch(tmp_path, compressor):
    data = _image(np.uint16)
    jroot, proot = _write_both(tmp_path, data, chunks=(32, 32), levels=1, compressor=compressor)
    for root in (jroot, proot):
        path = os.path.join(root, "0", "0.0.0.0.0")
        raw = open(path, "rb").read()
        open(path, "wb").write(raw[: len(raw) // 2] + b"\x00" * 7)
    coords = [(0, 0, 0, 0, 0, 16, 16), (0, 0, 0, 64, 64, 32, 32)]  # one lane is clean
    with pytest.raises(jzarr.ZarrError):
        jzarr.ZarrPixelBuffer(jroot).read_tiles(coords)
    with pytest.raises(pzarr.ZarrError):
        pzarr.ZarrPixelBuffer(proot).read_tiles(coords)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 100, 4099])
def test_crc32c_native_and_table_walk_match_jax(monkeypatch, n):
    data = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8).tobytes()
    want = jzarr.crc32c(data)
    assert pzarr.crc32c(data) == want
    monkeypatch.setattr(pzarr, "get_engine", lambda: None)
    assert pzarr.crc32c(data) == want
    assert pzarr.crc32c(b"123456789") == 0xE3069283
    engine = native.get_engine()
    if engine is not None:
        assert engine.has_crc32c and engine.crc32c(data) == want


def test_shard_index_memo_ttl_and_purge(tmp_path):
    data = _image(np.uint16)
    root = str(tmp_path / "img.zarr")
    pzarr.write_ngff(root, data, chunks=(32, 32), zarr_format=3, shards=(64, 64),
                     compressor="zlib")
    buf = pzarr.ZarrPixelBuffer(root, block_cache=BlockCache(0))
    arr = buf.levels[0]
    now = [0.0]
    arr._shard_clock = lambda: now[0]
    buf.get_tile_at(0, 0, 0, 0, 0, 0, 100, 60)
    assert len(arr._shard_indexes) == 2
    assert buf.purge_shard_indexes() == 2
    buf.get_tile_at(0, 0, 0, 0, 0, 0, 100, 60)
    now[0] = 301.0  # past the default TTL: a miss, reloaded
    assert arr._cached_shard_index(arr._chunk_key((0, 0, 0, 0, 0))) is pzarr._MISSING
    assert buf.note_epoch(7) == 1 and buf.note_epoch(7) == 0
