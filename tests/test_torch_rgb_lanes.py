"""RGB ``/tile`` PNG lanes: the port's ``handle_batch`` and ``handle``
against the JAX package's (``engine="device"``, single device), byte for
byte.

The images are scanner-style RGB TIFFs: three interleaved samples a
pixel and no OME-XML, so a read gives (h, w, 3) tiles; RGB8 (zlib tiles;
JPEG 4:2:0 tiles decoded by each package's own decoder) and RGB16 (zlib,
predictor 2). The lanes: bucket-sized, padded into a bucket, two bucket
sizes, one larger than every bucket (the host engine's fused encode), a
raw and a TIFF lane, in ``dynamic`` and ``rle`` with ``device_deflate``
on, and with it off (the filter on the device, the deflate on the host).
A lone lane goes through ``handle``. An OME ``SizeC = 3`` interleaved
image serves grey lanes, channel c being sample c. Tolerance: zero."""

import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu_torch.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import TilePipeline
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

BUCKETS = (64, 128)
W, H = 300, 220
# (x, y, w, h, format)
LANES = [
    (0, 0, 64, 64, "png"),
    (64, 64, 64, 64, "png"),
    (128, 0, 100, 80, "png"),    # padded into the 128 bucket
    (0, 128, 128, 90, "png"),
    (17, 33, 50, 41, "png"),     # padded into the 64 bucket
    (50, 10, 200, 150, "png"),   # larger than every bucket: host engine
    (236, 156, 64, 64, "png"),   # at the image's corner
    (10, 10, 40, 30, None),      # raw
    (5, 6, 70, 60, "tif"),
    (280, 0, 64, 64, "png"),     # off the plane: None in both
]


def _rgb(dtype, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    hi = 255 if dtype == np.uint8 else 65535
    chans = [hi * (0.5 + 0.3 * np.sin(xx / p + 0.5 * c) * np.cos(yy / (p + 7)))
             for c, p in enumerate((23.0, 37.0, 51.0))]
    rgb = np.stack(chans, -1) + rng.normal(0, hi / 60, (H, W, 3))
    return rgb.clip(0, hi).astype(dtype)


IMAGES = {
    "rgb8_zlib": (np.uint8, dict(compression="zlib")),
    "rgb8_jpeg420": (np.uint8, dict(compression="jpeg", jpeg_quality=85, jpeg_subsampling=2)),
    "rgb16_zlib_pred2": (np.uint16, dict(compression="zlib", predictor=2)),
}


@pytest.fixture(scope="module", params=sorted(IMAGES))
def image(request, tmp_path_factory):
    dtype, kw = IMAGES[request.param]
    path = str(tmp_path_factory.mktemp("rgb") / f"{request.param}.tif")
    write_ome_tiff(path, _rgb(dtype, 3)[None, None, None], tile_size=(64, 64), ome_xml=False,
                   **kw)
    return path


def _pipelines(path, **kw):
    """Both pipelines on ``path``; device deflate on unless ``kw`` says
    otherwise (the JAX constructor's default is off, its YAML's on)."""
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JR
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JS
    from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline as JP

    jreg, preg = JR(), ImageRegistry()
    jreg.add(1, path)
    preg.add(1, path)
    kw.setdefault("device_deflate", True)
    jax = JP(JS(jreg), engine="device", buckets=BUCKETS, **kw)
    jax.mesh = None
    port = TilePipeline(PixelsService(preg), buckets=BUCKETS, device="cpu", **kw)
    return jax, port


def _ctxs(lanes, c=0):
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JR
    from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JC

    port = [TileCtx(1, 0, c, 0, RegionDef(x, y, w, h), format=f, omero_session_key="k")
            for x, y, w, h, f in lanes]
    jax = [JC(1, 0, c, 0, JR(x, y, w, h), format=f, omero_session_key="k")
           for x, y, w, h, f in lanes]
    return port, jax


def _decode_png(body):
    from omero_ms_pixel_buffer_tpu.ops.png import decode_png

    return decode_png(body)


@pytest.mark.parametrize("kw", [
    dict(device_deflate=True, device_deflate_mode="dynamic"),
    dict(device_deflate=True, device_deflate_mode="rle"),
    dict(device_deflate=False),
], ids=["dynamic", "rle", "host_deflate"])
def test_rgb_lanes_equal_jax(image, kw):
    jax, port = _pipelines(image, **kw)
    try:
        pc, jc = _ctxs(LANES)
        got, want = port.handle_batch(pc), jax.handle_batch(jc)
        assert [g is None for g in got] == [w is None for w in want]
        assert want[-1] is None and sum(w is not None for w in want) == len(LANES) - 1
        for lane, g, w in zip(LANES, got, want):
            assert g == w, lane
        # RGB PNGs: colour type 2 at the pixel depth
        png = _decode_png(got[2])
        assert png.shape == (80, 100, 3)
        assert got[2][25] == 2 and got[2][24] == (8 if png.dtype == np.uint8 else 16)
        # the oversize lane took the host engine, every other PNG lane the
        # device route (bucket batches through the filter's plain version)
        assert port.host_png_lanes == 1
        if not kw["device_deflate"]:
            assert port.host_deflate_lanes == 6
        else:
            snap = port.device_queue_snapshot()
            assert snap["lanes"] == 6 and snap["failed"] == 0
    finally:
        port.close()


def test_lone_rgb_lane_through_handle(image):
    jax, port = _pipelines(image)
    try:
        for lane in [(3, 4, 64, 64, "png"), (0, 0, 0, 0, "png"), (9, 9, 30, 20, "tif")]:
            pc, jc = _ctxs([lane])
            assert port.handle(pc[0]) == jax.handle(jc[0]), lane
    finally:
        port.close()


def test_interleaved_page_with_ome_sizec_serves_grey_lanes(tmp_path):
    data = np.stack([_rgb(np.uint8, 4), _rgb(np.uint8, 5)])[None, :, None]  # C = 2 pages
    path = str(tmp_path / "rgb_sizec.ome.tif")
    write_ome_tiff(path, data, tile_size=(64, 64), compression="zlib")
    jax, port = _pipelines(path)
    try:
        lanes = [(0, 0, 64, 64, "png"), (30, 20, 100, 90, "png")]
        for c in range(6):  # SizeC = 6: page c // 3, sample c % 3
            pc, jc = _ctxs(lanes, c=c)
            got, want = port.handle_batch(pc), jax.handle_batch(jc)
            assert got == want, c
            np.testing.assert_array_equal(_decode_png(got[0]), data[0, c // 3, 0, :64, :64, c % 3])
    finally:
        port.close()


@pytest.mark.parametrize("fmt", ["png", "tif", None])
def test_romio_lanes_equal_jax(tmp_path, fmt):
    """ROMIO planes through both pipelines (the registry's ``romio``
    type), a batch of bucket and oversize lanes."""
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JR
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JS
    from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline as JP
    from omero_ms_pixel_buffer_tpu_torch.io.romio import write_romio

    rng = np.random.default_rng(8)
    data = rng.integers(0, 5000, (1, 2, 2, 150, 170)).astype(np.uint16)
    path = tmp_path / "Pixels" / "3"
    path.parent.mkdir()
    write_romio(str(path), data)
    entry = dict(type="romio", sizeX=170, sizeY=150, sizeZ=2, sizeC=2, sizeT=1,
                 pixelsType="uint16")
    jreg, preg = JR(), ImageRegistry()
    jreg.add(1, str(path), **entry)
    preg.add(1, str(path), **entry)
    jax = JP(JS(jreg), engine="device", buckets=BUCKETS, device_deflate=True)
    jax.mesh = None
    port = TilePipeline(PixelsService(preg), buckets=BUCKETS, device="cpu")
    try:
        lanes = [(0, 0, 64, 64, fmt), (10, 20, 100, 100, fmt), (0, 0, 0, 0, fmt)]
        for c in range(2):
            pc, jc = _ctxs(lanes, c=c)
            got, want = port.handle_batch(pc), jax.handle_batch(jc)
            assert got == want and all(g is not None for g in got)
    finally:
        port.close()


@pytest.fixture
def jpeg_image(tmp_path):
    path = str(tmp_path / "rgb_jpeg.tif")
    write_ome_tiff(path, _rgb(np.uint8, 6)[None, None, None], tile_size=(64, 64),
                   ome_xml=False, compression="jpeg", jpeg_quality=85, jpeg_subsampling=2)
    return path


def test_device_idct_lanes_within_bound_of_host(jpeg_image, monkeypatch):
    """``OMPB_JPEG_DEVICE_IDCT=1``: the reads' IDCT runs through the
    service's ``DeviceIdct`` (here on the CPU); the pixels stay within 3
    of the host IDCT's (see ``test_torch_jpeg.py`` for the bound)."""
    host = TilePipeline(PixelsService(_registry(jpeg_image)), buckets=BUCKETS, device="cpu")
    monkeypatch.setenv("OMPB_JPEG_DEVICE_IDCT", "1")
    dev = TilePipeline(PixelsService(_registry(jpeg_image), device="cpu"), buckets=BUCKETS,
                       device="cpu")
    try:
        lanes = LANES[:7]
        monkeypatch.setenv("OMPB_JPEG_DEVICE_IDCT", "0")
        want = host.handle_batch(_ctxs(lanes)[0])
        monkeypatch.setenv("OMPB_JPEG_DEVICE_IDCT", "1")
        got = dev.handle_batch(_ctxs(lanes)[0])
        for g, w in zip(got, want):
            diff = _decode_png(g).astype(int) - _decode_png(w).astype(int)
            assert np.abs(diff).max() <= 3
        snap = dev.pixels_service.idct.snapshot()
        assert snap["device_idct_calls"] > 0 and snap["device"] == "cpu"
        assert host.pixels_service.idct.calls == 0
    finally:
        host.close()
        dev.close()


def test_device_idct_failure_answers_500(jpeg_image, monkeypatch):
    from omero_ms_pixel_buffer_tpu_torch.errors import InternalError
    from omero_ms_pixel_buffer_tpu_torch.io import jpeg as pj

    def boom(*a, **k):
        raise RuntimeError("card lost")

    monkeypatch.setenv("OMPB_JPEG_DEVICE_IDCT", "1")
    monkeypatch.setattr(pj, "idct_blocks_torch", boom)
    pipe = TilePipeline(PixelsService(_registry(jpeg_image), device="cpu"), buckets=BUCKETS,
                        device="cpu")
    try:
        got = pipe.handle_batch(_ctxs(LANES[:3])[0])
        assert all(isinstance(g, InternalError) and g.code == 500 for g in got)
        lone = pipe.handle(_ctxs([(0, 0, 64, 64, "png")])[0][0])
        assert isinstance(lone, InternalError)
        assert pipe.pixels_service.idct.failed >= 2
    finally:
        pipe.close()


def test_corrupt_jpeg_block_fails_only_its_lanes(jpeg_image):
    from omero_ms_pixel_buffer_tpu_torch.io.ometiff import OmeTiffPixelBuffer

    buf = OmeTiffPixelBuffer(jpeg_image)
    # tile 6 (five tiles a row): x 64..127, y 64..127
    off, cnt = buf.ifds[0].values("TILE_OFFSETS")[6], buf.ifds[0].values("TILE_COUNTS")[6]
    buf.close()
    with open(jpeg_image, "r+b") as f:
        f.seek(off + cnt // 3)
        f.write(b"\xff\x00\x13\x37" * (cnt // 12))
    jax, port = _pipelines(jpeg_image)
    try:
        lanes = [(0, 0, 64, 64, "png"), (64, 64, 64, 64, "png"), (100, 100, 50, 40, "png"),
                 (128, 0, 64, 64, "png"), (70, 70, 10, 10, None)]
        got, want = port.handle_batch(_ctxs(lanes)[0]), jax.handle_batch(_ctxs(lanes)[1])
        assert [g is None for g in got] == [False, True, True, False, True]
        assert got == want
    finally:
        port.close()


def _registry(path):
    reg = ImageRegistry()
    reg.add(1, path)
    return reg
