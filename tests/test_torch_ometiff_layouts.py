"""The port's OME-TIFF and ROMIO readers against the JAX package's, on
files written from seeded numpy data.

- Every layout: compression none/zlib/LZW/PackBits/JPEG/zstd, predictor
  1 and 2 (where the codec allows it), tiles and strips, classic and
  BigTIFF, big- and little-endian; and every sample type
  (u8/i8/u16/i16/u32/i32/f32/f64) with one sample, with three interleaved
  under OME ``SizeC = 3`` (channel c is sample c) and three without
  OME-XML (an RGB page: (h, w, 3) tiles). The port's writer gives the
  JAX writer's bytes (``ome_xml=False`` only drops the description);
  both readers give equal metadata and equal arrays from ``get_tile_at``
  and ``read_tiles`` at level 0 and at a pyramid level, with the native
  engine and without it.
- A corrupt block (zlib, LZW, JPEG, zstd) fails only the lanes that
  touch it; the rest equal the JAX reader's.
- The IFD memo round trip (``memo_dir``): the port writes the JAX
  package's memo document, reads a memo without reparsing, and ignores a
  stale one; JPEG tables survive it.
- ROMIO through ``PixelsService``: the port's writer gives the JAX
  writer's bytes, the registry row is answered without opening the file,
  and tiles equal the JAX package's (its lanes through both pipelines
  are in ``test_torch_rgb_lanes.py``).
- A zstd TIFF without the ``zstandard`` package is refused at the first
  read in both.

Tolerance: zero (bytes, arrays, NaN where NaN)."""

import itertools
import json
import sys

import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu_torch.io import ometiff as po
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.ops.convert import omero_type_for

DTYPES = ["u1", "i1", "u2", "i2", "u4", "i4", "f4", "f8"]
SHAPE = (1, 2, 1, 40, 56)  # T, C, Z, Y, X (one plane of each channel)


def _data(dtype: str, samples: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = SHAPE + ((3,) if samples == 3 else ())
    dt = np.dtype(dtype)
    if dt.kind == "f":
        out = rng.normal(0, 500, shape).astype(dt)
        out.flat[7] = np.nan  # NaN survives every layout
        return out
    info = np.iinfo(dt)
    # smooth rows (the codecs compress them) around a level per plane
    # and sample spread over the type's range
    steps = rng.integers(-3, 4, shape).cumsum(axis=4)
    base = rng.integers(info.min // 2, info.max // 2, shape[:3] + (1, 1) + shape[5:])
    return np.clip(steps + base, info.min, info.max).astype(dt)


def _regions(w, h):
    """The whole plane, an interior rect across blocks, a corner."""
    return [(0, 0, w, h), (w // 8 + 1, h // 8, w // 2 + 5, h // 2 + 1), (w - 9, h - 7, 9, 7)]


def _write(tmp_path, data, ome_xml=True, **kw):
    from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff as jax_write

    jp, pp = str(tmp_path / "jax.tif"), str(tmp_path / "port.tif")
    if ome_xml:
        jax_write(jp, data, pyramid_levels=2, **kw)
    po.write_ome_tiff(pp, data, pyramid_levels=2, ome_xml=ome_xml, **kw)
    if ome_xml:
        with open(jp, "rb") as a, open(pp, "rb") as b:
            assert a.read() == b.read(), "the port's writer differs from the JAX writer"
    return pp


def _compare_readers(path, native=True, monkeypatch=None):
    from omero_ms_pixel_buffer_tpu.io.ometiff import OmeTiffPixelBuffer as JaxBuffer

    if not native:
        import omero_ms_pixel_buffer_tpu.runtime.native as jn
        import omero_ms_pixel_buffer_tpu_torch.runtime.native as pn

        monkeypatch.setattr(jn, "get_engine", lambda: None)
        monkeypatch.setattr(pn, "get_engine", lambda: None)
    jb, pb = JaxBuffer(path), po.OmeTiffPixelBuffer(path)
    try:
        for k in ("size_x", "size_y", "size_z", "size_c", "size_t", "pixels_type"):
            assert getattr(pb.meta, k) == getattr(jb.meta, k), k
        assert pb.resolution_levels == jb.resolution_levels == 2
        assert pb.samples == jb.samples
        for level in (0, 1):
            w, h = pb.level_size(level)
            assert (w, h) == jb.level_size(level)
            coords = [(0, c, 0) + r for c in range(pb.meta.size_c) for r in _regions(w, h)]
            got, want = pb.read_tiles(coords, level=level), jb.read_tiles(coords, level=level)
            for co, g, x in zip(coords, got, want):
                assert g.dtype == x.dtype and g.shape == x.shape, co
                np.testing.assert_array_equal(g, x, err_msg=str(co))
                np.testing.assert_array_equal(pb.get_tile_at(level, *co), x, err_msg=str(co))
        return pb.meta, pb.samples
    finally:
        jb.close()
        pb.close()


_COMP_PRED = [(c, 1) for c in (None, "zlib", "lzw", "packbits", "jpeg", "zstd")] + [
    (c, 2) for c in ("zlib", "lzw", "zstd")]
_LAYOUTS = list(itertools.product(_COMP_PRED, ("tiles", "strips"), ("classic", "bigtiff"),
                                  ("big_endian", "little_endian")))


@pytest.mark.parametrize(
    "comp_pred,storage,flavor,order", _LAYOUTS,
    ids=[f"{c}-p{p}-{s}-{f}-{o}" for (c, p), s, f, o in _LAYOUTS])
def test_every_layout_reads_equal(tmp_path, comp_pred, storage, flavor, order):
    comp, pred = comp_pred
    if comp == "zstd":
        pytest.importorskip("zstandard")
    idx = _LAYOUTS.index((comp_pred, storage, flavor, order))
    # JPEG is 8-bit unsigned; the other layouts take the sample types in turn
    dtype = "u1" if comp == "jpeg" else DTYPES[idx % len(DTYPES)]
    samples = 3 if (comp == "jpeg" and idx % 2) or (comp != "jpeg" and idx % 5 == 0) else 1
    data = _data(dtype, samples, seed=idx)
    path = _write(tmp_path, data, tile_size=(16, 16) if storage == "tiles" else None,
                  compression=comp, predictor=pred, bigtiff=flavor == "bigtiff",
                  big_endian=order == "big_endian", jpeg_quality=90,
                  jpeg_subsampling=idx % 3)
    meta, _ = _compare_readers(path)
    assert meta.size_c == 2 * samples
    if comp != "jpeg":  # lossless: the source pixels come back
        pb = po.OmeTiffPixelBuffer(path)
        try:
            for c in range(meta.size_c):
                src = data[0, c // samples, 0] if samples == 1 else data[0, c // 3, 0, :, :, c % 3]
                np.testing.assert_array_equal(pb.get_tile_at(0, 0, c, 0, 0, 0, 56, 40), src)
        finally:
            pb.close()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["grey", "rgb_ome_sizec", "rgb_no_ome"])
def test_every_sample_type_reads_equal(tmp_path, monkeypatch, dtype, form):
    samples = 1 if form == "grey" else 3
    data = _data(dtype, samples, seed=DTYPES.index(dtype))
    comp = "packbits" if dtype in ("u1", "i1") else "zlib"
    path = _write(tmp_path, data, ome_xml=form != "rgb_no_ome", tile_size=(16, 16),
                  compression=comp, predictor=2 if comp == "zlib" else 1)
    for native in (True, False):
        meta, got_samples = _compare_readers(path, native, monkeypatch)
        assert got_samples == samples
    if form == "rgb_no_ome":
        # no OME-XML: one plane (the first page, as in the JAX reader),
        # read as (h, w, 3) RGB tiles
        assert (meta.size_z, meta.size_c, meta.size_t) == (1, 1, 1)
        pb = po.OmeTiffPixelBuffer(path)
        try:
            np.testing.assert_array_equal(pb.get_tile_at(0, 0, 0, 0, 0, 0, 56, 40),
                                          data[0, 0, 0])
        finally:
            pb.close()
    elif form == "rgb_ome_sizec":
        assert meta.size_c == 6


def _corrupt(path, tile):
    """Overwrite the middle third of one tile's bytes in page 0."""
    pb = po.OmeTiffPixelBuffer(path)
    ifd = pb.ifds[0]
    off, cnt = ifd.values("TILE_OFFSETS")[tile], ifd.values("TILE_COUNTS")[tile]
    pb.close()
    with open(path, "r+b") as f:
        f.seek(off + cnt // 3)
        f.write(b"\xff\x00\x13\x37" * max(1, cnt // 12))


@pytest.mark.parametrize("comp", ["zlib", "lzw", "jpeg", "zstd"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "no_native"])
def test_corrupt_block_fails_only_its_lanes(tmp_path, monkeypatch, comp, native):
    from omero_ms_pixel_buffer_tpu.io.ometiff import OmeTiffPixelBuffer as JaxBuffer

    if comp == "zstd":
        pytest.importorskip("zstandard")
    data = _data("u1", 1, seed=5)
    path = _write(tmp_path, data, tile_size=(16, 16), compression=comp)
    _corrupt(path, 4)  # tile (row 1, col 0) of plane 0: x 0..15, y 16..31
    coords = [(0, 0, 0, 0, 0, 16, 16), (0, 0, 0, 2, 18, 10, 10), (0, 0, 0, 20, 0, 30, 30),
              (0, 1, 0, 0, 16, 16, 16), (0, 0, 0, 0, 0, 56, 40)]
    jb = JaxBuffer(path)
    want = jb.read_tiles(coords)  # the JAX reader with its native engine
    jb.close()
    if not native:
        import omero_ms_pixel_buffer_tpu_torch.runtime.native as pn

        monkeypatch.setattr(pn, "get_engine", lambda: None)
    pb = po.OmeTiffPixelBuffer(path)
    got = pb.read_tiles(coords)
    assert [g is None for g in got] == [False, True, False, False, True]
    assert [w is None for w in want] == [False, True, False, False, True]
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_array_equal(g, w)
    with pytest.raises(po.TiffError, match="Corrupt"):
        pb.get_tile_at(0, 0, 0, 0, 2, 18, 10, 10)
    pb.close()


def test_memo_round_trip(tmp_path, monkeypatch):
    from omero_ms_pixel_buffer_tpu.io import ometiff as jo

    data = _data("u1", 3, seed=9)
    path = _write(tmp_path, data, tile_size=(16, 16), compression="jpeg")
    jdir, pdir = tmp_path / "jmemo", tmp_path / "pmemo"
    jo.OmeTiffPixelBuffer(path, memo_dir=str(jdir)).close()
    first = po.OmeTiffPixelBuffer(path, memo_dir=str(pdir))
    want = first.read_tiles([(0, c, 0, 3, 4, 40, 30) for c in range(6)])
    first.close()
    (jmemo,), (pmemo,) = list(jdir.iterdir()), list(pdir.iterdir())
    assert jmemo.name == pmemo.name
    assert json.loads(pmemo.read_text()) == json.loads(jmemo.read_text())

    def no_parse(_mm):
        raise AssertionError("reparsed despite a fresh memo")

    monkeypatch.setattr(po, "_parse_ifds", no_parse)
    for memo_dir in (pdir, jdir):  # its own memo, and the JAX package's
        again = po.OmeTiffPixelBuffer(path, memo_dir=str(memo_dir))
        got = again.read_tiles([(0, c, 0, 3, 4, 40, 30) for c in range(6)])
        again.close()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # a stale memo (the file changed) is ignored: the reparse runs
    monkeypatch.undo()
    with open(path, "ab") as f:
        f.write(b"\x00\x00")
    monkeypatch.setenv("OMPB_MEMO_DIR", str(pdir))
    calls = []
    real = po._parse_ifds
    monkeypatch.setattr(po, "_parse_ifds", lambda mm: calls.append(1) or real(mm))
    po.OmeTiffPixelBuffer(path).close()
    assert calls == [1]


def test_zstd_without_zstandard_is_refused_in_both(tmp_path, monkeypatch):
    pytest.importorskip("zstandard")
    from omero_ms_pixel_buffer_tpu.io.ometiff import OmeTiffPixelBuffer as JaxBuffer
    from omero_ms_pixel_buffer_tpu.io.ometiff import TiffError as JaxTiffError

    path = _write(tmp_path, _data("u2", 1, seed=2), tile_size=(16, 16), compression="zstd")
    monkeypatch.setitem(sys.modules, "zstandard", None)
    for buf_cls, err in ((JaxBuffer, JaxTiffError), (po.OmeTiffPixelBuffer, po.TiffError)):
        buf = buf_cls(path)
        with pytest.raises(err, match="zstandard"):
            buf.read_tiles([(0, 0, 0, 0, 0, 16, 16)])
        buf.close()


def _romio(tmp_path, dtype):
    from omero_ms_pixel_buffer_tpu.io.romio import write_romio as jax_write
    from omero_ms_pixel_buffer_tpu_torch.io.romio import write_romio

    rng = np.random.default_rng(13)
    data = rng.integers(0, 4000, (2, 3, 2, 48, 64)).astype(dtype)
    jp, pp = tmp_path / "jax.romio", tmp_path / "Pixels" / "7"
    pp.parent.mkdir()
    jax_write(str(jp), data)
    write_romio(str(pp), data)
    assert jp.read_bytes() == pp.read_bytes()
    entry = {"id": 7, "path": "Pixels/7", "type": "romio", "sizeX": 64, "sizeY": 48,
             "sizeZ": 2, "sizeC": 3, "sizeT": 2, "pixelsType": omero_type_for(dtype)}
    reg = tmp_path / "registry.json"
    reg.write_text(json.dumps({"images": [entry]}))
    return str(reg), data


@pytest.mark.parametrize("dtype", ["uint8", "int16", "uint16", "float32"])
def test_romio_through_pixels_service(tmp_path, monkeypatch, dtype):
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JaxRegistry
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JaxService
    from omero_ms_pixel_buffer_tpu_torch.io.romio import RomioPixelBuffer

    reg, data = _romio(tmp_path, dtype)
    port, jax = PixelsService(ImageRegistry(reg)), JaxService(JaxRegistry(reg))
    opened = []
    monkeypatch.setattr(PixelsService, "_open", lambda self, *a: opened.append(a))
    meta = port.get_pixels(7)
    assert opened == []  # the registry row answers, the file stays shut
    monkeypatch.undo()
    jmeta = jax.get_pixels(7)
    for k in ("size_x", "size_y", "size_z", "size_c", "size_t", "pixels_type", "image_name"):
        assert getattr(meta, k) == getattr(jmeta, k), k
    buf, jbuf = port.get_pixel_buffer(7), jax.get_pixel_buffer(7)
    assert isinstance(buf, RomioPixelBuffer)
    coords = [(z, c, t, 3, 5, 40, 30) for z in range(2) for c in range(3) for t in range(2)]
    for co, g, w in zip(coords, buf.read_tiles(coords), jbuf.read_tiles(coords)):
        np.testing.assert_array_equal(g, w)
        z, c, t = co[:3]
        np.testing.assert_array_equal(g, data[t, c, z, 5:35, 3:43])
    with pytest.raises(ValueError, match="single-resolution"):
        buf.get_tile_at(1, 0, 0, 0, 0, 0, 8, 8)
    port.close()
    jax.close()
