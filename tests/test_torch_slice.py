"""The whole slice: the port's ``TilePipeline.handle_batch`` against the
JAX package's device pipeline (``engine="device"``, device deflate in
each of its modes ``dynamic``, ``rle`` and ``stored``) on one OME-TIFF,
over the bucket route (round 1) and the plane-cache route (round 2,
after the plane's admission touch), and the port's HTTP front on the
CPU. Tolerance: zero — PNG and TIFF bodies are compared byte for byte."""

import asyncio
import json

import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu.io.pixels_service import (
    ImageRegistry as JaxRegistry,
    PixelsService as JaxService,
)
from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline as JaxPipeline
from omero_ms_pixel_buffer_tpu.ops.png import decode_png
from omero_ms_pixel_buffer_tpu.ops.tiff import decode_tiff, encode_tiff
from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx
from omero_ms_pixel_buffer_tpu_torch.dispatch.batcher import BatchingTileWorker
from omero_ms_pixel_buffer_tpu_torch.http.server import TileServer
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import TilePipeline
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

SIZE = 1024
# (x, y, w, h, format): full buckets, odd sizes, lanes whose bucket
# overruns the right/bottom edge (bucket route in every round), a raw
# lane and an out-of-bounds lane (404 -> None)
LANES = [
    (0, 0, 512, 512, "png"),
    (64, 128, 512, 512, "png"),
    (512, 512, 512, 512, "png"),
    (300, 200, 300, 200, "png"),
    (17, 33, 300, 200, "png"),
    (0, 256, 256, 256, "png"),
    (768, 0, 256, 256, "png"),
    (724, 40, 300, 200, "png"),   # ends at the right edge: bucket route
    (100, 824, 300, 200, "png"),  # ends at the bottom edge: bucket route
    (40, 40, 64, 48, None),
    (1000, 0, 512, 512, "png"),   # overflows the plane: 404
    (0, 0, 64, 64, "bmp"),        # unknown format: None in both
    (0, 0, 0, 0, "tif"),          # the full plane as the JAX encode_tiff bytes
]


@pytest.fixture(scope="module")
def fixture_image(tmp_path_factory):
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    base = 2000 + 1500 * np.sin(xx / 97.0) + 1500 * np.cos(yy / 131.0)
    data = (base + rng.normal(0, 120, (SIZE, SIZE))).clip(0, 65535)
    data = data.astype(np.uint16)[None, None, None]
    path = str(tmp_path_factory.mktemp("slice") / "img.ome.tiff")
    write_ome_tiff(path, data, tile_size=(256, 256), compression="zlib")
    return path, data[0, 0, 0]


def _port_pipeline(path, **kwargs):
    reg = ImageRegistry()
    reg.add(1, path)
    return TilePipeline(PixelsService(reg), buckets=(256, 512), device="cpu", **kwargs)


def _match_jax_on_both_routes(path, truth, mode, **port_kwargs):
    """Two rounds of ``LANES`` through both pipelines in ``mode``; every
    lane's body equal. Returns the port's queue snapshot."""
    jreg = JaxRegistry()
    jreg.add(1, path)
    jax_pipe = JaxPipeline(
        JaxService(jreg), engine="device", device_deflate=True,
        device_deflate_mode=mode, buckets=(256, 512),
    )
    jax_pipe.mesh = None  # single device: the plane cache serves
    port = _port_pipeline(path, device_deflate_mode=mode, **port_kwargs)
    try:
        for _round in range(2):
            jctx = [JaxCtx(1, 0, 0, 0, JaxRegion(x, y, w, h), format=f,
                           omero_session_key="k") for x, y, w, h, f in LANES]
            pctx = [TileCtx(1, 0, 0, 0, RegionDef(x, y, w, h), format=f,
                            omero_session_key="k") for x, y, w, h, f in LANES]
            want = jax_pipe.handle_batch(jctx)
            got = port.handle_batch(pctx)
            for lane, g, w in zip(LANES, got, want):
                assert g == w, lane
            for (x, y, w, h, f), g in zip(LANES, got):
                if f == "png" and g is not None:
                    np.testing.assert_array_equal(decode_png(g), truth[y:y + h, x:x + w])
            assert got[-3] is None and got[-2] is None
            assert got[-4] == truth[40:88, 40:104].astype(">u2").tobytes()
            assert got[-1] == encode_tiff(truth)
            np.testing.assert_array_equal(decode_tiff(got[-1]), truth)
        # round 2 staged the plane and routed the fitting lanes through it
        assert len(port.plane_cache) == 1 and len(jax_pipe._plane_cache) == 1
        snap = port.device_queue_snapshot()
        assert snap["failed"] == 0 and snap["deflate_mode"] == mode
        return snap
    finally:
        jax_pipe.close()
        port.close()


def test_png_bytes_match_jax_on_both_routes(fixture_image):
    path, truth = fixture_image
    snap = _match_jax_on_both_routes(path, truth, "dynamic")
    assert {"plan", "pass2"} <= set(snap["stage_ms_mean"])


@pytest.mark.parametrize("mode", ["rle", "stored"])
def test_one_pass_modes_match_jax_on_both_routes(fixture_image, mode):
    path, truth = fixture_image
    snap = _match_jax_on_both_routes(path, truth, mode, packer="pallas_dense")
    assert snap["packer"] == "pallas_dense"
    assert set(snap["stage_ms_mean"]) == {"stage", "compute", "pull", "frame"}


def test_oversize_lane_encodes_on_device_path(fixture_image):
    """A lane larger than every bucket (the full plane, buckets 256/512)
    leaves the device path for the host route, as in the JAX package: its
    bytes equal JAX ``handle_batch``'s, beside a bucketed lane."""
    path, truth = fixture_image
    jreg = JaxRegistry()
    jreg.add(1, path)
    jax_pipe = JaxPipeline(JaxService(jreg), engine="device", device_deflate=True,
                           buckets=(256, 512))
    jax_pipe.mesh = None
    port = _port_pipeline(path)
    lanes = [(0, 0, 0, 0), (0, 0, 256, 256)]
    try:
        want = jax_pipe.handle_batch([JaxCtx(1, 0, 0, 0, JaxRegion(*r), format="png")
                                      for r in lanes])
        out = port.handle_batch([TileCtx(1, 0, 0, 0, RegionDef(*r), format="png")
                                 for r in lanes])
        assert out == want
        assert port.host_png_lanes == 1
        np.testing.assert_array_equal(decode_png(out[0]), truth)
    finally:
        jax_pipe.close()
        port.close()


async def _get(port, path, cookie=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        hdr = f"GET {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
        if cookie:
            hdr += f"Cookie: sessionid={cookie}\r\n"
        writer.write((hdr + "\r\n").encode())
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


async def test_http_front_on_cpu(fixture_image, monkeypatch):
    monkeypatch.delenv("OMPB_BITPACK", raising=False)
    path, truth = fixture_image
    pipeline = _port_pipeline(path)
    server = TileServer(BatchingTileWorker(pipeline),
                        sessions={"cookie1": "key1"})
    port = await server.start("127.0.0.1", 0)
    loop = asyncio.get_running_loop()
    try:
        q = "/tile/1/0/0/0?x=64&y=32&w=300&h=200&format=png"
        status, body = await _get(port, q, "cookie1")
        assert status == 200
        # a lone request takes the single-request path
        ctx = TileCtx(1, 0, 0, 0, RegionDef(64, 32, 300, 200), format="png")
        assert body == await loop.run_in_executor(None, pipeline.handle, ctx)
        assert (await _get(port, q))[0] == 403
        assert (await _get(port, q, "unknown"))[0] == 403
        status, body = await _get(port, "/tile/1/zz/0/0?format=png", "cookie1")
        assert (status, body) == (400, b'For input string: "zz"')
        assert (await _get(port, "/tile/99/0/0/0?format=png", "cookie1"))[0] == 404
        status, body = await _get(port, "/healthz")
        assert status == 200 and b'"failed": 0' in body
        queue = json.loads(body)["queue"]
        assert queue["deflate_mode"] == "dynamic" and queue["packer"] == "scan"
        status, body = await _get(port, "/tile/1/0/0/0?x=0&y=0&w=64&h=32&format=tif", "cookie1")
        assert status == 200
        np.testing.assert_array_equal(decode_tiff(body), truth[:32, :64])
    finally:
        await server.close()
        pipeline.close()


def test_failed_group_answers_500_and_is_counted(fixture_image, monkeypatch):
    """No host re-encode: a failing encode group fails its lanes."""
    from omero_ms_pixel_buffer_tpu_torch.errors import InternalError

    path, _ = fixture_image
    port = _port_pipeline(path)

    def boom(*args, **kwargs):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(port.dispatcher, "_stage_group", boom)
    try:
        out = port.handle_batch([
            TileCtx(1, 0, 0, 0, RegionDef(0, 0, 64, 64), format="png"),
            TileCtx(1, 0, 0, 0, RegionDef(0, 0, 64, 64), format=None),
        ])
        assert isinstance(out[0], InternalError) and out[0].code == 500
        assert isinstance(out[1], bytes)  # raw lanes never touch the queue
        assert port.device_queue_snapshot()["failed"] == 1
    finally:
        port.close()
