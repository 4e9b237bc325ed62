"""The port's ``/render`` plane and its ``device_deflate=False`` route
against the JAX package, end to end, on the CPU.

- ``TilePipeline.handle_batch`` on uint8 and uint16 OME-TIFFs of T = 2,
  C = 3, Z = 4 against the JAX ``TilePipeline(engine="device",
  device_deflate=True)`` (single device): composites, greyscale, LUTs,
  maps, z and t projections, ROI masks, JPEG, bucket padding, lanes
  larger than every bucket, an out-of-range channel (None) and a
  projection stack over ``max_tile_bytes`` (``RequestTooLargeError``),
  over three rounds so the plane cache goes from cold to admitted to warm;
  the projection host pulls are counted alike, and a warm projection pan
  stays on the device.
- The ``/render`` front against the JAX aiohttp app: status, body,
  ``ETag``, ``Cache-Control``, ``X-Cache``, 304 and HEAD.
- ``device_deflate=False`` against the JAX ``TilePipeline(device_deflate=
  False)``, with the native engine as found and with both packages'
  ``get_engine`` forced to None.
- A failed render group answers 500 (no host re-render).
- ``cuda``: the fused render chain on the card against its plain version.

JAX, aiohttp and Pillow are imported inside the tests and fixtures that
use them, so the ``cuda`` case also runs where only PyTorch is installed
(``python -m pytest tests/test_torch_render_pipeline.py -m cuda
--noconftest``). Tolerance: zero (statuses, header values and bytes)."""

import asyncio

import numpy as np
import pytest
import torch

import omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline as port_tp
from omero_ms_pixel_buffer_tpu_torch.dispatch.batcher import BatchingTileWorker
from omero_ms_pixel_buffer_tpu_torch.errors import InternalError, RequestTooLargeError
from omero_ms_pixel_buffer_tpu_torch.http.server import TileServer
from omero_ms_pixel_buffer_tpu_torch.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
from omero_ms_pixel_buffer_tpu_torch.render import engine as pe
from omero_ms_pixel_buffer_tpu_torch.render.luts import LutRegistry, write_imagej_lut
from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

SHAPE = (2, 3, 4, 200, 260)  # T, C, Z, Y, X
BUCKETS = (64, 128)
BUDGET = 600_000  # max_tile_bytes: a full-plane 3 x 4-plane stack is over it
ROI = '[{"type": "ellipse", "cx": 90, "cy": 80, "rx": 40, "ry": 25}]'
# (query, z, t, region); the path's c is 1 for every lane
LANES = [
    ({"c": "1|0:3000$FF0000,2|0:4000$00FF00,3$0000FF"}, 0, 0, (0, 0, 64, 48)),
    ({"c": "1|0:3000$FF0000,2|0:4000$00FF00,3$0000FF"}, 1, 1, (64, 32, 100, 100)),
    ({"c": "1|0:3000$FF0000,2|0:4000$00FF00,3$0000FF"}, 2, 0, (0, 0, 200, 150)),  # > buckets
    ({"c": "2|100:3000", "m": "g"}, 3, 1, (100, 50, 128, 128)),
    ({}, 0, 1, (10, 20, 64, 64)),  # the path's channel alone, in grey
    ({"c": "1|0:2000$fire,3|50:900$spectrum"}, 2, 1, (5, 7, 60, 41)),
    ({"c": "1,2,3", "maps": '[{"reverse": {"enabled": true}}, {"quantization": '
      '{"family": "logarithmic", "coefficient": 4}}]'}, 1, 0, (128, 64, 128, 128)),
    ({"c": "1|0:4000$FF0000,2$00FF00", "p": "intmax|0:3"}, 0, 0, (0, 0, 128, 128)),
    ({"c": "1|0:4000$FF0000,2$00FF00", "p": "intmax|0:3"}, 0, 1, (64, 64, 100, 70)),
    ({"c": "3", "p": "intmean"}, 0, 0, (128, 0, 128, 128)),
    ({"c": "1,2", "p": "intmax:t"}, 2, 0, (30, 40, 64, 64)),
    ({"c": "2$FF00FF", "p": "intmean:t|0:1"}, 3, 1, (0, 64, 128, 100)),
    ({"c": "1|0:4000$FF0000", "p": "intmax"}, 0, 0, (0, 0, 250, 190)),  # > buckets
    ({"c": "1|0:4000$FF0000,2$00FF00", "roi": ROI}, 1, 0, (40, 40, 100, 100)),
    ({"c": "1|0:4000$FF0000", "roi": ROI, "p": "intmax"}, 0, 0, (64, 64, 64, 64)),
    ({"c": "1|0:4000$FF0000,3$0000FF", "format": "jpeg", "q": "0.8"}, 0, 0, (0, 0, 64, 64)),
    ({"c": "7"}, 0, 0, (0, 0, 64, 64)),  # channel out of range -> None
    ({"p": "intmax|9:12"}, 0, 0, (0, 0, 64, 64)),  # projection outside the stack
    ({"c": "1,2,3", "p": "intmax"}, 0, 0, (0, 0, 0, 0)),  # over the budget -> 413
    ({"c": "1|0:4000$FF0000"}, 0, 0, (300, 0, 64, 64)),  # region off the plane -> None
]


def _data(dtype):
    rng = np.random.default_rng(71)
    info = np.iinfo(dtype)
    hi = 4096 if info.max > 4096 else info.max
    return rng.integers(0, hi, SHAPE, dtype=dtype)


@pytest.fixture(scope="module", params=["u8", "u16"])
def image(request, tmp_path_factory):
    data = _data(np.uint8 if request.param == "u8" else np.uint16)
    path = str(tmp_path_factory.mktemp("render") / f"img_{request.param}.ome.tiff")
    write_ome_tiff(path, data, tile_size=(64, 64), compression="zlib")
    return path, data


def _jax_pipeline(path, **kwargs):
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JR
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JS
    from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline as JP

    reg = JR()
    reg.add(1, path)
    pipe = JP(JS(reg), engine="device", buckets=BUCKETS, max_tile_bytes=BUDGET, **kwargs)
    pipe.mesh = None  # single device: the plane cache serves
    return pipe


def _port_pipeline(path, **kwargs):
    reg = ImageRegistry()
    reg.add(1, path)
    return port_tp.TilePipeline(PixelsService(reg), buckets=BUCKETS, device="cpu",
                                max_tile_bytes=BUDGET, **kwargs)


def _ctxs(lanes):
    """The same lanes as port and JAX contexts."""
    from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxSpec
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
    from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx

    port, jax = [], []
    for query, z, t, region in lanes:
        ps, js = RenderSpec.from_params(query, 1), JaxSpec.from_params(query, 1)
        port.append(TileCtx(1, z, 1, t, RegionDef(*region), format=ps.format,
                            omero_session_key="k", render=ps))
        jax.append(JaxCtx(1, z, 1, t, JaxRegion(*region), format=js.format,
                          omero_session_key="k", render=js))
    return port, jax


def _assert_same(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, Exception):
            assert type(g).__name__ == type(w).__name__ and g.code == w.code, (what, i)
            assert g.message == w.message, (what, i)
        else:
            assert g == w, (what, i, None if g is None else len(g), None if w is None else len(w))


def test_handle_batch_matches_jax(image):
    """Three rounds of every lane (cold, planes admitted, warm), then a
    warm projection pan alone: equal results lane by lane, equal host
    pulls of plane-cache crops, and the warm pan pulls nothing."""
    path, _ = image
    jp, pp = _jax_pipeline(path, device_deflate=True), _port_pipeline(path)
    try:
        for rnd in range(3):
            port_ctxs, jax_ctxs = _ctxs(LANES)
            want = jp.handle_batch(jax_ctxs)
            got = pp.handle_batch(port_ctxs)
            _assert_same(got, want, f"round {rnd}")
            assert (pp.render_snapshot()["projection_host_pulls"]
                    == jp.render_snapshot()["projection_host_pulls"]), rnd
        assert isinstance(got[-2], RequestTooLargeError) and got[-2].code == 413
        assert got[-4] is None and got[-3] is None and got[-1] is None
        assert got[15][:2] == b"\xff\xd8"  # JPEG on the host mirror
        pan = [lane for lane in LANES[7:12] if lane[3][2] <= 128 and lane[3][3] <= 128]
        pulls = pp.render_snapshot()["projection_host_pulls"]
        groups = pp.dispatcher.snapshot()["render_groups"]
        port_ctxs, jax_ctxs = _ctxs(pan)
        _assert_same(pp.handle_batch(port_ctxs), jp.handle_batch(jax_ctxs), "warm pan")
        assert pp.render_snapshot()["projection_host_pulls"] == pulls
        assert pp.dispatcher.snapshot()["render_groups"] > groups
        assert pp.render_snapshot()["host_lanes"] > 0
    finally:
        jp.close()
        pp.close()


def test_rendered_pixels_match_a_numpy_composite(image):
    """The served PNG decodes to the numpy composite of the source planes."""
    from omero_ms_pixel_buffer_tpu.ops.png import decode_png

    path, data = image
    pp = _port_pipeline(path)
    try:
        query = {"c": "1|0:3000$FF0000,2|0:4000$00FF00,3$0000FF", "p": "intmax|1:2"}
        port_ctxs, _ = _ctxs([(query, 0, 1, (20, 30, 64, 50))])
        png = pp.handle_batch(port_ctxs * 2)[0]
        tables, luts = pe.build_tables(RenderSpec.from_params(query), data.dtype, LutRegistry())
        stack = data[1, :, 1:3, 30:80, 20:84].max(axis=1)
        np.testing.assert_array_equal(decode_png(png), pe.render_host(stack, tables, luts))
    finally:
        pp.close()


@pytest.fixture(params=["native", "python"])
def engine_state(request, monkeypatch):
    """Both packages' host engine as found, or forced to None."""
    import omero_ms_pixel_buffer_tpu.models.tile_pipeline as jax_tp
    from omero_ms_pixel_buffer_tpu_torch.runtime import native

    if request.param == "python":
        monkeypatch.setattr(jax_tp, "get_engine", lambda: None)
        monkeypatch.setattr(port_tp, "get_engine", lambda: None)
    elif native.get_engine() is None:
        pytest.skip("the native engine does not build here")
    return request.param


def test_device_deflate_false_matches_jax(image, engine_state):
    """PNG /tile lanes filtered on the device and deflated on the host
    (bucket route, then plane route once the planes are admitted; lanes
    larger than every bucket on the host lane route), and render lanes on
    the host mirror, against the JAX device_deflate=False pipeline."""
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
    from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx

    path, _ = image
    jp, pp = _jax_pipeline(path, device_deflate=False), _port_pipeline(path, device_deflate=False)
    regions = [(0, 0, 64, 48), (64, 32, 100, 100), (0, 0, 128, 128), (132, 72, 128, 128),
               (10, 10, 200, 150)]
    try:
        for rnd in range(3):
            port_ctxs, jax_ctxs = _ctxs(LANES[:2] + LANES[7:9])
            for z, c in ((0, 0), (3, 2)):
                for r in regions:
                    port_ctxs.append(TileCtx(1, z, c, 1, RegionDef(*r), format="png",
                                             omero_session_key="k"))
                    jax_ctxs.append(JaxCtx(1, z, c, 1, JaxRegion(*r), format="png",
                                           omero_session_key="k"))
            _assert_same(pp.handle_batch(port_ctxs), jp.handle_batch(jax_ctxs), rnd)
        assert pp.host_deflate_lanes == 3 * 8
        assert pp.plane_cache.snapshot()["hits"] > 0
        assert pp.dispatcher.snapshot()["groups"] == 0  # nothing deflated on the device
    finally:
        jp.close()
        pp.close()


def test_failed_render_group_answers_500(image, monkeypatch):
    path, _ = image
    pp = _port_pipeline(path)

    def broken(*args):
        raise RuntimeError("render chain down")

    monkeypatch.setattr(pp.dispatcher, "_stage_render_group", broken)
    try:
        port_ctxs, _ = _ctxs(LANES[:2] + LANES[15:16])
        out = pp.handle_batch(port_ctxs)
        assert all(isinstance(r, InternalError) and r.code == 500 for r in out[:2])
        assert out[2][:2] == b"\xff\xd8"  # the JPEG lane never reaches the queue
        assert pp.dispatcher.snapshot()["failed"] == 2
    finally:
        pp.close()


# -- the /render front against the JAX aiohttp app ------------------------------------

COOKIE = {"Cookie": "sessionid=ck"}
COMPARED = ("Content-Type", "Content-Disposition", "ETag", "Cache-Control", "X-Cache")
BASE = "/render/1/0/0/0?c=1|0:3000$FF0000,2|0:4000$00FF00&w=64&h=64"


class Fronts:
    """The JAX aiohttp app and the port's server over one image and one LUT
    directory, each answering ``request(method, path, headers)``."""

    async def start(self, path, lut_dir):
        from aiohttp.test_utils import TestClient, TestServer

        from omero_ms_pixel_buffer_tpu.auth.stores import MemorySessionStore
        from omero_ms_pixel_buffer_tpu.http.server import PixelBufferApp
        from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JR
        from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JS
        from omero_ms_pixel_buffer_tpu.utils.config import Config

        jreg = JR()
        jreg.add(1, path)
        config = Config.from_dict({
            "session-store": {"type": "memory"}, "cache": {"prefetch": {"enabled": False}},
            "backend": {"max-tile-mb": 1}, "render": {"lut-dir": lut_dir}})
        self.jax_app = PixelBufferApp(config, pixels_service=JS(jreg),
                                      session_store=MemorySessionStore({"ck": "key1"}))
        self.jax = TestClient(TestServer(self.jax_app.make_app()),
                              loop=asyncio.get_running_loop())
        await self.jax.start_server()
        reg = ImageRegistry()
        reg.add(1, path)
        self.pipeline = port_tp.TilePipeline(PixelsService(reg), buckets=(256, 512),
                                             device="cpu", lut_dir=lut_dir,
                                             max_tile_bytes=1 << 20)
        self.port = TileServer(BatchingTileWorker(self.pipeline), sessions={"ck": "key1"})
        self.port_no = await self.port.start("127.0.0.1", 0)
        return self

    async def close(self):
        await self.jax.close()
        await self.port.close()
        self.pipeline.close()

    async def port_request(self, method, path, headers=None):
        reader, writer = await asyncio.open_connection("127.0.0.1", self.port_no)
        try:
            head = f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
            for k, v in (headers or {}).items():
                head += f"{k}: {v}\r\n"
            writer.write((head + "\r\n").encode())
            await writer.drain()
            raw = await reader.read()
        finally:
            writer.close()
        top, _, body = raw.partition(b"\r\n\r\n")
        lines = top.decode("latin-1").split("\r\n")
        hdrs = {k.lower(): v for k, v in (ln.split(": ", 1) for ln in lines[1:])}
        return int(lines[0].split()[1]), hdrs, body

    async def both(self, method, path, headers=None):
        r = await self.jax.request(method, path, headers=headers or {})
        js, jh, jb = r.status, {k.lower(): v for k, v in r.headers.items()}, await r.read()
        ps, ph, pb = await self.port_request(method, path, headers)
        assert ps == js, (method, path, ps, js, pb, jb)
        assert pb == jb, (method, path)
        for name in COMPARED:
            assert ph.get(name.lower()) == jh.get(name.lower()), (name, method, path)
        if method == "HEAD" or ps != 304:
            assert ph.get("content-length") == jh.get("content-length"), (method, path)
        return ps, ph, pb


@pytest.fixture(scope="module")
def http_image(tmp_path_factory):
    root = tmp_path_factory.mktemp("render_http")
    path = str(root / "img.ome.tiff")
    write_ome_tiff(path, _data(np.uint16), tile_size=(64, 64), compression="zlib")
    luts = root / "luts"
    luts.mkdir()
    write_imagej_lut(str(luts / "Teal.lut"),
                     np.stack([np.zeros(256), np.arange(256), np.arange(256)], 1))
    return path, str(luts)


async def _with_fronts(http_image, body):
    f = await Fronts().start(*http_image)
    try:
        await body(f)
    finally:
        await f.close()


RENDER_URLS = [
    BASE,
    BASE + "&format=jpeg&q=0.6",
    "/render/1/2/1/1?w=64&h=64&x=64",  # the path's channel alone
    "/render/1/0/0/0?c=1|0:4000$FF0000,2$00FF00&p=intmax|0:3&x=64&y=64&w=128&h=128",
    "/render/1/1/0/1?c=3&p=intmean:t&w=100&h=60",
    "/render/1/0/0/0?c=2|100:3000&m=g&w=64&h=64",
    "/render/1/0/0/0?c=1$teal,2|0:900$fire&w=64&h=64",
    BASE + '&roi=[{"type":"rect","x":5,"y":5,"w":30,"h":20}]',
    BASE + '&maps=[{"reverse":{"enabled":true}},{"quantization":'
           '{"family":"logarithmic","coefficient":4}}]',
    BASE + "&annotations=1",
    "/render/1/0/0/0?c=1|0:3000$FF0000&x=3&y=5&w=250&h=190",  # padded to 256
]
ERROR_URLS = [
    "/render/1/0/0/0?c=1|9:1$FF0000&w=32&h=32", "/render/1/0/0/0?c=zz",
    "/render/1/0/0/0?m=q", "/render/1/0/0/0?p=no", "/render/1/0/0/0?q=7",
    "/render/1/0/0/0?format=gif", "/render/1/0/0/0?c=1$not-a-lut",
    "/render/1/0/0/0?x=abc", "/render/1/0/0/0?resolution=1.5", "/render/1/zz/0/0",
    "/render/1/0/0/0?roi=[]",
    "/render/1/0/0/0?c=9&w=32&h=32", "/render/77/0/0/0?w=32&h=32",
    "/render/1/0/0/0?c=1,2,3&p=intmax&w=0&h=0",  # a stack over max-tile-mb -> 413
    "/render/1/0/0/0?p=intmax|7:9",
]


@pytest.mark.parametrize("url", RENDER_URLS, ids=range(len(RENDER_URLS)))
async def test_render_front_matches_jax(http_image, url):
    """Miss then hit: equal bodies, ETags, Cache-Control and X-Cache; a
    matching If-None-Match answers 304; HEAD answers the GET's headers."""
    async def body(f):
        status, hdrs, got = await f.both("GET", url, COOKIE)
        assert (status, hdrs["x-cache"]) == (200, "miss") and got
        assert (await f.both("GET", url, COOKIE))[1]["x-cache"] == "hit"
        status, _, got = await f.both("GET", url, {**COOKIE, "If-None-Match": hdrs["etag"]})
        assert (status, got) == (304, b"")
        status, head, got = await f.both("HEAD", url, COOKIE)
        assert (status, got, head["etag"]) == (200, b"", hdrs["etag"])
    await _with_fronts(http_image, body)


async def test_render_errors_match_jax(http_image):
    """400s (grammar, unknown LUT, region parameters, path), 404s (channel
    out of range, unknown image, projection outside the stack), the 413 of
    a stack over the budget and the 403 without a session."""
    async def body(f):
        statuses = []
        for url in ERROR_URLS:
            statuses.append((await f.both("GET", url, COOKIE))[0])
        assert statuses == [400] * 11 + [404, 404, 413, 404]
        assert (await f.both("GET", BASE))[0] == 403
        health = (await f.port_request("GET", "/healthz"))[2]
        assert b'"render": {"enabled": true' in health
    await _with_fronts(http_image, body)


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rle", "stored"])
@pytest.mark.parametrize("packer", ["pallas", "pallas_dense"])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_fused_render_chain_matches_plain(cuda_device, mode, packer, masked):
    """Six 3-channel uint16 lanes of 300 x 200 in a 512 bucket: the chain
    on the card (the filter and packer kernels) against the same chain on
    the CPU (their plain versions), byte for byte."""
    rng = np.random.default_rng(5)
    planes = rng.integers(0, 65536, (6, 3, 512, 512), dtype=np.uint16)
    spec = RenderSpec.from_params({"c": "1|500:30000$FF0000,2|1000:40000$00FF00,3$fire"})
    tables, luts = pe.build_tables(spec, np.dtype(np.uint16), LutRegistry())
    mask = rng.integers(0, 2, (6, 512, 512), dtype=np.uint8) if masked else None
    cpu = pe.fused_render_filter_deflate_batch(
        bits_tensor(planes), tables, luts, 200, 1 + 300 * 3, mode=mode, packer=packer,
        mask=None if mask is None else torch.from_numpy(mask))
    dev = pe.fused_render_filter_deflate_batch(
        bits_tensor(planes).to(cuda_device), tables, luts, 200, 1 + 300 * 3, mode=mode,
        packer=packer, mask=None if mask is None else torch.from_numpy(mask).to(cuda_device))
    assert torch.equal(dev[1].cpu(), cpu[1])
    assert torch.equal(dev[0].cpu(), cpu[0])
    rgb_dev = pe.render_torch(bits_tensor(planes).to(cuda_device), tables, luts)
    assert torch.equal(rgb_dev.cpu(), pe.render_torch(bits_tensor(planes), tables, luts))
