"""The port's host encode routes against the JAX package's, byte for byte.

A lone request (the batcher's batch of one) takes ``TilePipeline.handle``
(host read, numpy filter, Python zlib) in both packages. A PNG lane larger
than every bucket takes ``_host_png_lanes`` in ``handle_batch``: the native
engine's fused encode when it builds and loads, else the per-lane Python
encode. Both engine states are held: as found (native, when it builds
here) and with both packages' ``get_engine`` forced to None. The image is
1300 x 1500 (uint16 and uint8), the buckets 256/512/1024, the probe lanes
a lone 512 x 512 tile, the full plane and a 1100 x 300 lane. Tolerance:
zero (bytes)."""

import numpy as np
import pytest

import omero_ms_pixel_buffer_tpu.models.tile_pipeline as jax_tp
from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu.io.pixels_service import (
    ImageRegistry as JaxRegistry,
    PixelsService as JaxService,
)
from omero_ms_pixel_buffer_tpu.ops.png import decode_png
from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx
import omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline as port_tp
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.runtime import native as port_native
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

WIDTH, HEIGHT = 1300, 1500
BUCKETS = (256, 512, 1024)
# (x, y, w, h): the lone 512 x 512 probe, the full plane (w = h = 0), and
# a 1100 x 300 lane; the last two are larger than every bucket
PROBES = [(128, 256, 512, 512), (0, 0, 0, 0), (100, 900, 1100, 300)]


@pytest.fixture(scope="module", params=["u16", "u8"])
def image(request, tmp_path_factory):
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float32)
    base = 2000 + 1500 * np.sin(xx / 97.0) + 1500 * np.cos(yy / 131.0)
    data = (base + rng.normal(0, 120, (HEIGHT, WIDTH))).clip(0, 65535).astype(np.uint16)
    if request.param == "u8":
        data = (data >> 6).astype(np.uint8)
    path = str(tmp_path_factory.mktemp("host") / f"img_{request.param}.ome.tiff")
    write_ome_tiff(path, data[None, None, None], tile_size=(256, 256), compression="zlib")
    return path, data


@pytest.fixture(params=["native", "python"])
def engine_state(request, monkeypatch):
    """Both packages' host engine as found, or forced to None."""
    if request.param == "python":
        monkeypatch.setattr(jax_tp, "get_engine", lambda: None)
        monkeypatch.setattr(port_tp, "get_engine", lambda: None)
    elif port_native.get_engine() is None:
        pytest.skip("the native engine does not build here")
    return request.param


@pytest.fixture
def pipelines(image):
    path, data = image
    jreg = JaxRegistry()
    jreg.add(1, path)
    jax_pipe = jax_tp.TilePipeline(JaxService(jreg), engine="device", device_deflate=True,
                                   buckets=BUCKETS)
    jax_pipe.mesh = None  # single device
    reg = ImageRegistry()
    reg.add(1, path)
    port = port_tp.TilePipeline(PixelsService(reg), buckets=BUCKETS, device="cpu")
    yield jax_pipe, port, data
    jax_pipe.close()
    port.close()


def _ctxs(lanes):
    return ([JaxCtx(1, 0, 0, 0, JaxRegion(*r), format="png", omero_session_key="k")
             for r in lanes],
            [TileCtx(1, 0, 0, 0, RegionDef(*r), format="png", omero_session_key="k")
             for r in lanes])


def _truth(data, x, y, w, h):
    w, h = w or data.shape[1], h or data.shape[0]
    return data[y:y + h, x:x + w]


@pytest.mark.parametrize("lane", PROBES, ids=["lone_512", "full_plane", "lane_1100x300"])
def test_lone_request_matches_jax_handle(pipelines, engine_state, lane):
    jax_pipe, port, data = pipelines
    (jctx,), (pctx,) = _ctxs([lane])
    want = jax_pipe.handle(jctx)
    got = port.handle(pctx)
    assert got == want and got is not None
    np.testing.assert_array_equal(decode_png(got), _truth(data, *lane))
    assert port.host_png_lanes == 0  # the single-request path, not the lane route


def test_oversize_lanes_match_jax_handle_batch(pipelines, engine_state):
    """The three probes in one batch: the two oversize lanes take the host
    lane route (the native engine, or Python without it), the 512 x 512
    lane the device chain; every body equals JAX ``handle_batch``'s."""
    jax_pipe, port, data = pipelines
    jctx, pctx = _ctxs(PROBES)
    want = jax_pipe.handle_batch(jctx)
    got = port.handle_batch(pctx)
    assert got == want
    assert port.host_png_lanes == 2
    for lane, body in zip(PROBES, got):
        np.testing.assert_array_equal(decode_png(body), _truth(data, *lane))


def test_engines_differ_on_an_oversize_lane(image):
    """Why both engine states are held: the native "fast" encoder and
    Python zlib give different bytes for the same pixels."""
    if port_native.get_engine() is None:
        pytest.skip("the native engine does not build here")
    from omero_ms_pixel_buffer_tpu_torch.ops.png import encode_png

    _, data = image
    tile = _truth(data, *PROBES[2])
    native = port_native.get_engine().png_encode_batch([tile], "up", 6, "fast")[0]
    assert native != encode_png(tile)
    np.testing.assert_array_equal(decode_png(native), tile)


def test_host_engine_is_named():
    assert port_native.host_engine() in ("native", "python")
