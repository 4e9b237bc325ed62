"""``/tile`` of JPEG-in-TIFF images through the port's ``create_server``
(what ``python -m omero_ms_pixel_buffer_tpu_torch`` serves) against the
JAX package's aiohttp app, on the same URLs, one request at a time: PNG,
TIFF and raw bodies, statuses and the headers both fronts set, for a
scanner-style RGB image (4:2:0 JPEG tiles, no OME-XML: RGB lanes) at two
pyramid levels and a grey one, plus a region off the plane (404). The
port's ``/healthz`` shows the JPEG view. Tolerance: zero."""

import asyncio
import json

import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu_torch.http.server import create_server
from omero_ms_pixel_buffer_tpu_torch.io.ometiff import write_ome_tiff

COOKIE = {"Cookie": "sessionid=ck"}
COMPARED = ("Content-Type", "Content-Disposition", "ETag", "Cache-Control", "X-Cache")
URLS = [
    "/tile/1/0/0/0?x=0&y=0&w=128&h=128&format=png",
    "/tile/1/0/0/0?x=37&y=21&w=90&h=70&format=png",
    "/tile/1/0/0/0?x=0&y=0&w=0&h=0&format=png",
    "/tile/1/0/0/0?x=10&y=12&w=64&h=50&format=tif",
    "/tile/1/0/0/0?x=10&y=12&w=64&h=50",
    "/tile/1/0/0/0?x=0&y=0&w=100&h=80&format=png&resolution=1",
    "/tile/1/0/0/0?x=200&y=0&w=128&h=128&format=png",
    "/tile/2/0/0/0?x=5&y=6&w=120&h=100&format=png",
    "/tile/2/0/0/0?x=5&y=6&w=120&h=100&format=tif",
    "/tile/2/0/0/0?x=5&y=6&w=20&h=10",
]


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    root = tmp_path_factory.mktemp("httpjpeg")
    rng = np.random.default_rng(23)
    yy, xx = np.mgrid[0:180, 0:260].astype(np.float32)
    rgb = np.stack([128 + 90 * np.sin(xx / (9 + 4 * c) + c) * np.cos(yy / 13)
                    for c in range(3)], -1) + rng.normal(0, 5, (180, 260, 3))
    rgb = rgb.clip(0, 255).astype(np.uint8)
    write_ome_tiff(str(root / "rgb.tif"), rgb[None, None, None], tile_size=(64, 64),
                   pyramid_levels=2, compression="jpeg", jpeg_quality=85, jpeg_subsampling=2,
                   ome_xml=False)
    write_ome_tiff(str(root / "grey.ome.tif"), rgb[None, None, None, :, :, 1],
                   tile_size=(64, 64), compression="jpeg", jpeg_quality=90)
    reg = root / "registry.json"
    reg.write_text(json.dumps({"images": [{"id": 1, "path": "rgb.tif"},
                                          {"id": 2, "path": "grey.ome.tif"}]}))
    return str(reg)


async def _port_get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        head = f"GET {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
        head += "".join(f"{k}: {v}\r\n" for k, v in COOKIE.items())
        writer.write((head + "\r\n").encode())
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    top, _, body = raw.partition(b"\r\n\r\n")
    lines = top.decode("latin-1").split("\r\n")
    hdrs = {k.lower(): v for k, v in (ln.split(": ", 1) for ln in lines[1:])}
    return int(lines[0].split()[1]), hdrs, body


async def test_jpeg_tiff_tiles_equal_the_jax_app(registry):
    from aiohttp.test_utils import TestClient, TestServer

    from omero_ms_pixel_buffer_tpu.auth.stores import MemorySessionStore
    from omero_ms_pixel_buffer_tpu.http.server import PixelBufferApp
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JR
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JS
    from omero_ms_pixel_buffer_tpu.utils.config import Config

    config = Config.from_dict({"session-store": {"type": "memory"},
                               "cache": {"prefetch": {"enabled": False}}})
    app = PixelBufferApp(config, pixels_service=JS(JR(registry)),
                         session_store=MemorySessionStore({"ck": "ck"}))
    jax = TestClient(TestServer(app.make_app()), loop=asyncio.get_running_loop())
    await jax.start_server()
    server = create_server(registry, dev=True, device="cpu")
    port = await server.start("127.0.0.1", 0)
    try:
        statuses = []
        for url in URLS:
            r = await jax.get(url, headers=COOKIE)
            jbody, jh = await r.read(), {k.lower(): v for k, v in r.headers.items()}
            status, ph, pbody = await _port_get(port, url)
            assert status == r.status, url
            assert pbody == jbody, url
            for name in COMPARED:
                assert ph.get(name.lower()) == jh.get(name.lower()), (name, url)
            statuses.append(status)
        assert statuses.count(404) == 1 and statuses.count(200) == len(URLS) - 1
        health = server.health()
        assert health["jpeg"]["idct_mode"] == "host"
        assert health["jpeg"]["device_idct_calls"] == 0
    finally:
        await jax.close()
        await server.close()
        server.pipeline.close()
