"""The port's whole-host engine against the JAX package's, on the CPU.

``backend.engine: host`` and ``backend.batching.device-encode: false``
(both the JAX ``host`` engine) through both fronts built from one config
dict (the JAX aiohttp app, the port's ``wire``): ``/tile`` PNG, raw and
TIF, ``/render`` (composites, greyscale, a projection, an ROI mask,
JPEG), ``/histogram``, failures and a concurrent burst of adjacent
``/render`` tiles, each URL twice (miss, hit), with equal statuses,
bodies and ``ETag``/``Cache-Control``/``X-Cache`` headers. Under the
fronts, ``handle_batch`` of both pipelines on PNG batches (lanes larger
than every bucket included) with the native engine as found and forced
off, on a batcher-stamped 4x4 pan (one host composite and host carves)
and on histogram lanes. Last, the port's host pipeline is built and
serves with every ``torch.cuda`` entry, ``resolve_device``, the encode
queue and the plane cache replaced by functions that raise: it builds
none of them and makes no CUDA call. Tolerance: zero (statuses, header
values and bytes)."""

import asyncio
import copy

import numpy as np
import pytest
import torch

import omero_ms_pixel_buffer_tpu.models.tile_pipeline as jax_tp
import omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline as port_tp
from omero_ms_pixel_buffer_tpu_torch.auth.stores import MemorySessionStore
from omero_ms_pixel_buffer_tpu_torch.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.render import supertile as pst
from omero_ms_pixel_buffer_tpu_torch.render.analysis import HistogramSpec
from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
from omero_ms_pixel_buffer_tpu_torch.runtime import native as port_native
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx
from omero_ms_pixel_buffer_tpu_torch.utils import config as pconfig

SHAPE = (1, 3, 2, 192, 256)  # T, C, Z, Y, X
BUCKETS = (64, 128)
COOKIE = {"Cookie": "sessionid=ck"}
# headers the two fronts must agree on, where present
COMPARED = ("Content-Type", "Content-Disposition", "ETag", "Cache-Control", "X-Cache",
            "Retry-After", "Allow")
ROI = "%5B%7B%22type%22%3A%22ellipse%22%2C%22cx%22%3A30%2C%22cy%22%3A30%2C%22rx%22%3A20%2C%22ry%22%3A12%7D%5D"
C3 = "c=1|0:4000$FF0000,2|0:4000$00FF00,3|0:4000$0000FF"
URLS = [
    "/tile/1/0/0/0?x=0&y=0&w=64&h=64&format=png",
    "/tile/1/1/2/0?x=30&y=20&w=100&h=60&format=png",
    "/tile/1/0/0/0?w=0&h=0&format=png",  # the full plane: larger than every bucket
    "/tile/1/0/1/0?x=64&y=32&w=100&h=60",
    "/tile/1/1/0/0?x=5&y=7&w=40&h=33&format=tif",
    f"/render/1/0/0/0?{C3}&x=64&y=0&w=64&h=64",
    "/render/1/1/0/0?c=2|100:3000&m=g&x=0&y=64&w=100&h=80",
    "/render/1/0/0/0?c=1|0:4000$FF0000,2$00FF00&p=intmax&x=0&y=0&w=128&h=96",
    f"/render/1/0/0/0?c=1|0:4000$FF0000&roi={ROI}&x=0&y=0&w=64&h=64",
    "/render/1/0/0/0?c=1|0:4000$FF0000,3$0000FF&format=jpeg&q=0.8&w=64&h=64",
    "/render/1/0/0/0?c=1|0:4000$FF0000&x=0&y=0&w=250&h=190",  # larger than every bucket
    "/histogram/1/0/0/0?bins=32&w=128&h=128&c=1,2",
    "/histogram/1/1/0/0?bins=256&usePixelsTypeRange=1",
    "/tile/9/0/0/0?format=png",
    "/render/1/0/0/0?c=9",
    "/tile/1/0/0/0?x=300&y=0&w=64&h=64&format=png",
]
ENGINES = {
    "engine-host": {"engine": "host"},
    "device-encode-false": {"batching": {"device-encode": False}},
}


def base_config(**blocks) -> dict:
    """The contract tests' config (memory sessions, no prefetcher) with
    ``blocks`` merged in."""
    raw = {"session-store": {"type": "memory"},
           "backend": {"batching": {"buckets": list(BUCKETS)}},
           "cache": {"prefetch": {"enabled": False}}}
    for key, value in blocks.items():
        _merge(raw.setdefault(key, {}), value)
    return raw


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)


class ConfigFronts:
    """The JAX aiohttp app and the port's ``wire`` from one config dict
    over the same images, each answering ``request(method, path,
    headers) -> (status, headers, body)``."""

    async def start(self, raw: dict, images: dict):
        from aiohttp.test_utils import TestClient, TestServer

        from omero_ms_pixel_buffer_tpu.auth.stores import MemorySessionStore as JaxStore
        from omero_ms_pixel_buffer_tpu.http.server import PixelBufferApp
        from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JaxRegistry
        from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JaxService
        from omero_ms_pixel_buffer_tpu.utils.config import Config as JaxConfig
        from omero_ms_pixel_buffer_tpu_torch.http.server import wire

        jreg, reg = JaxRegistry(), ImageRegistry()
        for image_id, path in images.items():
            jreg.add(image_id, path)
            reg.add(image_id, path)
        self.jax_app = PixelBufferApp(JaxConfig.from_dict(raw), pixels_service=JaxService(jreg),
                                      session_store=JaxStore({"ck": "key1"}))
        self.jax = TestClient(TestServer(self.jax_app.make_app()),
                              loop=asyncio.get_running_loop())
        await self.jax.start_server()
        self.port = wire(pconfig.Config.from_dict(raw), pixels_service=PixelsService(reg),
                         session_store=MemorySessionStore({"ck": "key1"}), device="cpu")
        self.port_no = await self.port.start("127.0.0.1", 0)
        return self

    async def close(self):
        await self.jax.close()
        await self.port.close()
        self.port.pipeline.close()

    async def jax_request(self, method, path, headers=None):
        r = await self.jax.request(method, path, headers=headers or {})
        return r.status, {k.lower(): v for k, v in r.headers.items()}, await r.read()

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
        hdrs = dict(ln.split(": ", 1) for ln in lines[1:])
        return int(lines[0].split()[1]), {k.lower(): v for k, v in hdrs.items()}, body

    @staticmethod
    def assert_alike(jax_answer, port_answer, what):
        (js, jh, jb), (ps, ph, pb) = jax_answer, port_answer
        assert ps == js, (what, ps, js)
        assert pb == jb, what
        for name in COMPARED:
            assert ph.get(name.lower()) == jh.get(name.lower()), (name, what)

    async def both(self, method, path, headers=None):
        """The same request to both fronts; asserts they answer alike and
        returns the port's answer."""
        want = await self.jax_request(method, path, headers)
        got = await self.port_request(method, path, headers)
        self.assert_alike(want, got, (method, path))
        return got

    async def burst(self, paths, headers=None):
        """``paths`` sent at once to each front in turn; asserts equal
        answers path by path."""
        want = await asyncio.gather(*(self.jax_request("GET", p, headers) for p in paths))
        got = await asyncio.gather(*(self.port_request("GET", p, headers) for p in paths))
        for p, w, g in zip(paths, want, got):
            self.assert_alike(w, g, p)
        return got


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    data = np.random.default_rng(23).integers(0, 4096, SHAPE, dtype=np.uint16)
    path = str(tmp_path_factory.mktemp("host_engine") / "img.ome.tiff")
    write_ome_tiff(path, data, tile_size=(64, 64), compression="zlib")
    return path, data


@pytest.fixture
def restore_process_state():
    """``wire`` configures the breaker board, the retry policy, the I/O
    timeout and the read plane process-wide: put the defaults back."""
    from omero_ms_pixel_buffer_tpu_torch.io import fetch
    from omero_ms_pixel_buffer_tpu_torch.resilience import breaker, configure

    yield
    default = pconfig.Config.from_dict({"session-store": {"type": "memory"}})
    configure(default.resilience)
    fetch.configure(default.io)
    breaker.BOARD.reset()


@pytest.mark.parametrize("engine", list(ENGINES))
async def test_fronts_match_jax_on_the_host_engine(image, engine, restore_process_state):
    """Every URL twice through both fronts: equal statuses, bodies and
    headers; the port serves on the host engine with no device object."""
    path, _ = image
    f = await ConfigFronts().start(base_config(backend=ENGINES[engine]), {1: path})
    try:
        assert f.port.pipeline.engine == "host" and f.jax_app.pipeline.engine == "host"
        for url in URLS:
            first = await f.both("GET", url, COOKIE)
            second = await f.both("GET", url, COOKIE)
            if first[0] == 200:
                assert (first[1].get("x-cache"), second[1].get("x-cache")) == ("miss", "hit")
                await f.both("GET", url, {**COOKIE, "If-None-Match": first[1]["etag"]})
        # a 4x4 pan of adjacent render tiles at once: fused or not, the
        # host bytes are the same
        await f.burst([f"/render/1/1/0/0?{C3}&x={x}&y={y}&w=64&h=48"
                       for y in range(0, 192, 48) for x in range(0, 256, 64)], COOKIE)
        health = f.port.health()
        assert health["plane_cache"] is None and health["queue"] is None
        assert health["device"] == "host" and health["gpu"] is None
        assert health["config"]["pipeline_engine"] == "host"
        assert health["analysis"]["device_groups"] == 0
        assert health["render"]["host_lanes"] > 0
        assert f.port.kernel_libraries == {}
    finally:
        await f.close()


# -- the pipelines -------------------------------------------------------------------


@pytest.fixture(params=["native", "python"])
def engine_state(request, monkeypatch):
    """Both packages' native host engine as found, or forced to None."""
    if request.param == "python":
        monkeypatch.setattr(jax_tp, "get_engine", lambda: None)
        monkeypatch.setattr(port_tp, "get_engine", lambda: None)
    elif port_native.get_engine() is None:
        pytest.skip("the native engine does not build here")
    return request.param


def host_pipelines(path, **policy):
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JaxRegistry
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JaxService

    jreg, reg = JaxRegistry(), ImageRegistry()
    jreg.add(1, path)
    reg.add(1, path)
    jax_pipe = jax_tp.TilePipeline(JaxService(jreg), engine="host", buckets=BUCKETS,
                                   **{f"png_{k}": v for k, v in policy.items()})
    port = port_tp.TilePipeline(PixelsService(reg), engine="host", buckets=BUCKETS,
                                **{f"png_{k}": v for k, v in policy.items()})
    return jax_pipe, port


def tile_ctxs(lanes, fmt="png"):
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
    from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx

    return ([JaxCtx(1, z, c, 0, JaxRegion(*r), format=fmt, omero_session_key="k")
             for z, c, r in lanes],
            [TileCtx(1, z, c, 0, RegionDef(*r), format=fmt, omero_session_key="k")
             for z, c, r in lanes])


PNG_LANES = [(0, 0, (0, 0, 64, 64)), (1, 2, (64, 0, 64, 64)), (0, 1, (10, 20, 50, 30)),
             (0, 0, (0, 0, 0, 0)), (1, 0, (0, 0, 200, 150))]


@pytest.mark.parametrize("policy", [{}, {"filter": "paeth", "level": 9, "strategy": "default"},
                                    {"filter": "sub", "level": 1, "strategy": "rle"},
                                    {"filter": "adaptive", "level": 6, "strategy": "fast"}],
                         ids=["up.6.fast", "paeth.9.default", "sub.1.rle", "adaptive.6.fast"])
def test_host_png_batches_match_jax(image, engine_state, policy):
    """PNG batches on the host engine (the fused native call, or Python
    per lane) under four policies; raw and TIF lanes ride along."""
    path, data = image
    jax_pipe, port = host_pipelines(path, **policy)
    try:
        jctx, pctx = tile_ctxs(PNG_LANES)
        want = jax_pipe.handle_batch(jctx)
        got = port.handle_batch(pctx)
        assert got == want and all(isinstance(b, bytes) for b in got)
        assert port.host_png_lanes == len(PNG_LANES)
        for fmt in (None, "tif"):
            jctx, pctx = tile_ctxs(PNG_LANES[:3], fmt)
            assert port.handle_batch(pctx) == jax_pipe.handle_batch(jctx)
        (jone,), (pone,) = tile_ctxs(PNG_LANES[1:2])
        assert port.handle(pone) == jax_pipe.handle(jone)
    finally:
        jax_pipe.close()
        port.close()


def _render_ctxs(lanes):
    from omero_ms_pixel_buffer_tpu.render.analysis import HistogramSpec as JaxHist
    from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxRender
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
    from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx

    port, jax = [], []
    for z, query, region, hist in lanes:
        p = TileCtx(1, z, 0, 0, RegionDef(*region), omero_session_key="k")
        j = JaxCtx(1, z, 0, 0, JaxRegion(*region), omero_session_key="k")
        if hist:
            p.analysis, j.analysis = (HistogramSpec.from_params(query),
                                      JaxHist.from_params(query))
            p.format = j.format = "json"
        else:
            p.render, j.render = RenderSpec.from_params(query), JaxRender.from_params(query)
            p.format, j.format = p.render.format, j.render.format
        port.append(p)
        jax.append(j)
    return port, jax


def test_stamped_pan_and_histograms_match_jax(image):
    """A batcher-stamped 4x4 pan (one host composite, host carves: counted
    as fused host lanes), render lanes beside it and histogram lanes, in
    one batch, under ``paeth`` (render lanes filter with it)."""
    path, data = image
    jax_pipe, port = host_pipelines(path, filter="paeth")
    try:
        from omero_ms_pixel_buffer_tpu.render.supertile import assign_supertiles as jax_assign

        q = {"c": "1|0:4000$FF0000,2|0:3000$00FF00"}
        pan = [(1, q, (x, y, 64, 48), False) for y in range(0, 192, 48) for x in range(0, 256, 64)]
        pctx, jctx = _render_ctxs(pan)
        assert pst.assign_supertiles(pctx) == jax_assign(jctx) == 16
        extra_p, extra_j = _render_ctxs([
            (0, {"c": "2|100:3000", "m": "g"}, (5, 5, 70, 40), False),
            (0, {"c": "1,2", "bins": "64"}, (0, 0, 128, 128), True),
            (1, {"c": "3", "bins": "300", "usePixelsTypeRange": "1"}, (0, 0, 0, 0), True),
        ])
        got = port.handle_batch(pctx + extra_p)
        assert got == jax_pipe.handle_batch(jctx + extra_j)
        assert all(isinstance(b, bytes) for b in got)
        snap = port.supertile_snapshot()
        assert snap["groups"] == 1 and snap["host_lanes"] == 16 and snap["device_lanes"] == 0
        assert port.render_snapshot()["host_lanes"] == 17
        assert port.analysis_snapshot()["device_groups"] == 0
    finally:
        jax_pipe.close()
        port.close()


def test_host_pipeline_touches_no_device(image, monkeypatch, restore_process_state):
    """``wire`` of a host-engine config with ``device="cuda"`` on a host
    with no card: every ``torch.cuda`` entry, ``resolve_device``, the
    encode queue and the plane cache raise if reached; the service is
    built and serves tiles, renders, a stamped pan and histograms."""
    from omero_ms_pixel_buffer_tpu_torch.http.server import wire

    def boom(*_args, **_kwargs):
        raise AssertionError("the host engine reached the device")

    for name in ("is_available", "device_count", "current_device", "init", "synchronize",
                 "set_device", "get_device_name", "Event", "Stream", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, boom)
    for name in ("resolve_device", "DeviceEncodeDispatcher", "DevicePlaneCache", "make_mesh",
                 "MeshManager"):
        monkeypatch.setattr(port_tp, name, boom)
    path, data = image
    reg = ImageRegistry()
    reg.add(1, path)
    server = wire(pconfig.Config.from_dict(base_config(backend={"engine": "host"})),
                  pixels_service=PixelsService(reg), device="cuda", dev=True)
    pipe = server.pipeline
    try:
        assert (pipe.device, pipe.dispatcher, pipe.plane_cache, pipe.mesh) == (None,) * 4
        assert pipe.mesh_manager() is None and pipe.last_mesh_dispatch is None
        _, pctx = tile_ctxs(PNG_LANES)
        q = {"c": "1|0:4000$FF0000,2|0:3000$00FF00"}
        pan, _ = _render_ctxs([(1, q, (x, y, 64, 96), False)
                               for y in (0, 96) for x in (0, 64)])
        assert pst.assign_supertiles(pan) == 4
        rest, _ = _render_ctxs([(0, {"c": "1,2", "p": "intmax"}, (0, 0, 64, 64), False),
                                (0, {"c": "1,2"}, (0, 0, 64, 64), True)])
        got = pipe.handle_batch(pctx + pan + rest)
        assert all(isinstance(b, bytes) for b in got)
        np.testing.assert_array_equal(
            _decode(got[0]), data[0, 0, 0, :64, :64])
        health = server.health()
        assert health["plane_cache"] is None and health["queue"] is None
        assert health["kernels"] == {name: 0 for name in health["kernels"]}
        assert pipe.supertile_snapshot()["host_lanes"] == 4
    finally:
        pipe.close()


def _decode(body: bytes) -> np.ndarray:
    from omero_ms_pixel_buffer_tpu.ops.png import decode_png

    return decode_png(body)
