"""Zarr sources through the whole slice: the port's ``handle_batch`` on the
CPU against the JAX device pipeline (``engine="device"``) over a registry
of OME-NGFF images served from a directory (Zarr v2, blosc-lz4), an HTTP
hierarchy (Zarr v3, sharded) and the SigV4-checking S3 stub (Zarr v3,
uint8): ``/tile`` PNG in ``dynamic``, ``rle`` and ``stored``, raw and
TIF, ``/render`` and ``/histogram``, on the bucket route and then the
plane route; a corrupt chunk (404 for its batched read's lanes); and, on
the two HTTP fronts, a stopped store (404 while its retries fail, then
503 with ``Retry-After`` once its breaker opens, 200 after it heals) and
``/healthz`` ``io``; and the reference's own fault, a cold read past 32
store requests a tile (JAX None, the port JAX's warm bytes). Inputs are
made from a seed with numpy. Tolerance:
zero — bodies byte for byte, statuses and ``Retry-After`` equal."""

import asyncio
import functools
import os
import shutil
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from test_zarr_stores import ACCESS_KEY, SECRET_KEY, _DirHandler, _FakeS3Handler
from test_torch_http_contract import COOKIE

from omero_ms_pixel_buffer_tpu.io.zarr import write_ngff
from omero_ms_pixel_buffer_tpu.resilience import breaker as jbreaker
from omero_ms_pixel_buffer_tpu_torch.io import zarr as pzarr
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.models import tile_pipeline as port_tp
from omero_ms_pixel_buffer_tpu_torch.render.analysis import HistogramSpec
from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
from omero_ms_pixel_buffer_tpu_torch.resilience import breaker as pbreaker
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

BUCKETS = (64, 128)
BUDGET = 1 << 20


def _serve_dir(root, handler_cls, port=0):
    """A threaded HTTP server over ``root`` on 127.0.0.1 (a stopped
    server restarts on its old port)."""
    server = ThreadingHTTPServer(("127.0.0.1", port), functools.partial(handler_cls, root))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _field(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    t, c, z, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty(shape, dtype)
    top = 250 if np.dtype(dtype).itemsize == 1 else 60000
    for ci in range(c):
        for zi in range(z):
            base = 0.4 * top + 0.25 * top * np.sin(xx / (17.0 + 5 * ci) + zi) * np.cos(yy / 23.0)
            out[0, ci, zi] = (base + rng.normal(0, 0.02 * top, (h, w))).clip(0, top)
    return out


IMAGES = {  # id: (name, data, writer options, source)
    1: ("a.zarr", _field((1, 3, 2, 300, 260), np.uint16, 1),
        dict(chunks=(64, 64), levels=3, compressor="blosc-lz4"), "dir"),
    2: ("b.zarr", _field((1, 3, 2, 300, 260), np.uint16, 2),
        dict(chunks=(32, 32), levels=2, compressor="blosc-zlib", zarr_format=3,
             shards=(64, 64)), "http"),
    3: ("c.zarr", _field((1, 3, 1, 200, 180), np.uint8, 3),
        dict(chunks=(64, 64), levels=2, compressor="zlib", zarr_format=3), "s3"),
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("zarr_pipeline")
    for name, data, opts, _ in IMAGES.values():
        write_ngff(str(root / name), data, **opts)
    return str(root)


@pytest.fixture(scope="module")
def servers(tree):
    http = _serve_dir(tree, _DirHandler)
    s3 = _serve_dir(tree, _FakeS3Handler)
    env = {"AWS_ACCESS_KEY_ID": ACCESS_KEY, "AWS_SECRET_ACCESS_KEY": SECRET_KEY,
           "AWS_REGION": "us-east-1",
           "OMPB_S3_ENDPOINT": f"http://127.0.0.1:{s3.server_address[1]}",
           "AWS_SHARED_CREDENTIALS_FILE": os.path.join(tree, "no-credentials"),
           "AWS_CONFIG_FILE": os.path.join(tree, "no-config")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    yield f"http://127.0.0.1:{http.server_address[1]}"
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    for server in (http, s3):
        server.shutdown()
        server.server_close()


@pytest.fixture(autouse=True)
def fresh_breakers():
    jbreaker.BOARD.reset()
    pbreaker.BOARD.reset()
    yield
    jbreaker.BOARD.reset()
    pbreaker.BOARD.reset()


def _paths(tree, http_root):
    out = {}
    for iid, (name, _, _, source) in IMAGES.items():
        if source == "dir":
            out[iid] = (os.path.join(tree, name), {})
        elif source == "http":
            out[iid] = (f"{http_root}/{name}", {})
        else:
            out[iid] = (f"s3://{_FakeS3Handler.bucket}/{name}", {"type": "zarr"})
    return out


def _pipelines(paths, mode="dynamic", **port_kwargs):
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JR
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JS
    from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline as JP

    jreg, preg = JR(), ImageRegistry()
    for iid, (path, extra) in paths.items():
        jreg.add(iid, path, **extra)
        preg.add(iid, path, **extra)
    jax = JP(JS(jreg), engine="device", device_deflate=True, device_deflate_mode=mode,
             buckets=BUCKETS, max_tile_bytes=BUDGET)
    jax.mesh = None  # single device: the plane cache serves
    port = port_tp.TilePipeline(PixelsService(preg), buckets=BUCKETS, device="cpu",
                                device_deflate_mode=mode, max_tile_bytes=BUDGET, **port_kwargs)
    return jax, port


# (kind, image, query, z, c, t, region, resolution, format)
LANES = [
    ("tile", 1, None, 0, 0, 0, (0, 0, 64, 64), None, "png"),
    ("tile", 1, None, 1, 2, 0, (70, 30, 100, 90), None, "png"),
    ("tile", 1, None, 0, 1, 0, (200, 236, 60, 64), None, "png"),  # edge lane
    ("tile", 1, None, 0, 1, 0, (0, 0, 65, 75), 1, "png"),
    ("tile", 1, None, 1, 0, 0, (10, 10, 40, 30), 2, None),
    ("tile", 1, None, 0, 2, 0, (5, 9, 77, 61), None, "tif"),
    ("tile", 2, None, 0, 0, 0, (0, 0, 64, 64), None, "png"),
    ("tile", 2, None, 1, 1, 0, (33, 65, 128, 100), None, "png"),
    ("tile", 2, None, 0, 2, 0, (0, 0, 130, 150), 1, "png"),
    ("tile", 2, None, 0, 0, 0, (40, 50, 64, 64), None, None),
    ("tile", 3, None, 0, 0, 0, (0, 0, 64, 64), None, "png"),
    ("tile", 3, None, 0, 2, 0, (100, 120, 80, 80), None, "png"),
    ("tile", 3, None, 0, 1, 0, (0, 0, 90, 100), 1, "tif"),
    ("tile", 1, None, 0, 0, 0, (250, 0, 64, 64), None, "png"),  # off the plane: 404
    ("render", 1, {"c": "1|1000:50000$FF0000,2|0:60000$00FF00,3$0000FF"}, 0, 0, 0,
     (0, 0, 64, 64), None, "png"),
    ("render", 2, {"c": "1,3", "p": "intmax", "m": "g"}, 0, 0, 0, (60, 40, 100, 64), None, "png"),
    ("render", 3, {"c": "2|10:200$FF00FF"}, 0, 0, 0, (0, 0, 128, 128), None, "png"),
    ("hist", 1, {"c": "1,2,3", "bins": "256"}, 1, 0, 0, (10, 20, 100, 60), None, "json"),
    ("hist", 2, {"usePixelsTypeRange": "1", "bins": "65536"}, 0, 1, 0, (0, 0, 64, 64), None,
     "json"),
    ("hist", 3, {"c": "1,3"}, 0, 0, 0, (30, 30, 90, 90), None, "json"),
]


def _ctxs(lanes):
    from omero_ms_pixel_buffer_tpu.render.analysis import HistogramSpec as JaxHist
    from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxRender
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
    from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx

    port, jax = [], []
    for kind, iid, query, z, c, t, region, res, fmt in lanes:
        p = TileCtx(iid, z, c, t, RegionDef(*region), format=fmt, omero_session_key="k",
                    resolution=res)
        j = JaxCtx(iid, z, c, t, JaxRegion(*region), format=fmt, omero_session_key="k",
                   resolution=res)
        if kind == "hist":
            p.analysis = HistogramSpec.from_params(query, default_channel=c)
            j.analysis = JaxHist.from_params(query, default_channel=c)
        elif kind == "render":
            p.render, j.render = RenderSpec.from_params(query, c), JaxRender.from_params(query, c)
        port.append(p)
        jax.append(j)
    return port, jax


def _assert_same(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, Exception):
            assert type(g).__name__ == type(w).__name__ and g.code == w.code, (what, i)
        else:
            assert g == w, (what, i, LANES[i] if len(got) == len(LANES) else i)


@pytest.mark.parametrize("mode", ["dynamic", "rle", "stored"])
def test_zarr_lanes_match_jax_on_both_routes(tree, servers, mode):
    jax, port = _pipelines(_paths(tree, servers), mode)
    try:
        for rnd in range(2):  # the bucket route, then the plane route
            pctx, jctx = _ctxs(LANES)
            want, got = jax.handle_batch(jctx), port.handle_batch(pctx)
            _assert_same(got, want, (mode, rnd))
            assert got[13] is None
            assert sum(g is not None for g in got) == len(LANES) - 1
        assert len(port.plane_cache) > 0
        assert port.device_queue_snapshot()["failed"] == 0
    finally:
        jax.close()
        port.close()


def test_single_requests_match_jax(tree, servers):
    jax, port = _pipelines(_paths(tree, servers))
    try:
        pctx, jctx = _ctxs([lane for lane in LANES if lane[0] == "tile"])
        for p, j in zip(pctx, jctx):
            assert port.handle(p) == jax.handle(j), (p.image_id, p.region)
    finally:
        jax.close()
        port.close()


def test_corrupt_chunk_fails_its_batched_read(tree, servers, tmp_path):
    bad = str(tmp_path / "bad.zarr")
    shutil.copytree(os.path.join(tree, "a.zarr"), bad)
    chunk = os.path.join(bad, "0", "0.0.0.0.0")
    raw = open(chunk, "rb").read()
    open(chunk, "wb").write(raw[:40] + b"\x07" * 40)
    paths = _paths(tree, servers)
    paths[1] = (bad, {"type": "zarr"})
    lanes = [("tile", 1, None, 0, 0, 0, (0, 0, 64, 64), None, "png"),     # the corrupt chunk
             ("tile", 1, None, 0, 0, 0, (128, 128, 64, 64), None, "png"),  # a clean one, same read
             ("tile", 1, None, 0, 0, 0, (0, 0, 64, 64), 1, "png"),        # level 1: its own read
             ("tile", 2, None, 0, 0, 0, (0, 0, 64, 64), None, "png"),
             ("render", 1, {"c": "1,2"}, 0, 0, 0, (0, 0, 64, 64), None, "png"),
             ("hist", 1, {"c": "1"}, 0, 0, 0, (0, 0, 64, 64), None, "json")]
    jax, port = _pipelines(paths)
    try:
        pctx, jctx = _ctxs(lanes)
        got, want = port.handle_batch(pctx), jax.handle_batch(jctx)
        _assert_same(got, want, "corrupt")
        assert got[0] is None and got[1] is None and got[4] is None and got[5] is None
        assert got[2] is not None and got[3] is not None
        pctx, jctx = _ctxs(lanes[:1])
        assert port.handle(pctx[0]) is None and jax.handle(jctx[0]) is None
    finally:
        jax.close()
        port.close()


def test_fill_value_for_an_absent_chunk(tree, servers, tmp_path):
    holed = str(tmp_path / "holed.zarr")
    shutil.copytree(os.path.join(tree, "a.zarr"), holed)
    os.remove(os.path.join(holed, "0", "0.1.0.1.1"))
    paths = _paths(tree, servers)
    paths[1] = (holed, {})
    lanes = [("tile", 1, None, 0, 1, 0, (32, 32, 128, 128), None, "png"),
             ("tile", 1, None, 0, 1, 0, (64, 64, 64, 64), None, None)]
    jax, port = _pipelines(paths)
    try:
        pctx, jctx = _ctxs(lanes)
        got = port.handle_batch(pctx)
        _assert_same(got, jax.handle_batch(jctx), "absent")
        assert got[1] == b"\x00" * (64 * 64 * 2)
    finally:
        jax.close()
        port.close()


def test_big_endian_array_answers_as_jax(tree, servers, tmp_path):
    """A ``">u2"`` v2 image cannot be opened by either reader: every lane
    of it answers as in JAX (404), and the other images' lanes are served."""
    be = str(tmp_path / "be.zarr")
    write_ngff(be, IMAGES[1][1].astype(">u2"), chunks=(64, 64), levels=1, compressor="zlib")
    paths = _paths(tree, servers)
    paths[1] = (be, {})
    lanes = [("tile", 1, None, 0, 0, 0, (0, 0, 64, 64), None, "png"),
             ("tile", 1, None, 0, 1, 0, (0, 0, 64, 64), None, None),
             ("render", 1, {"c": "1,2"}, 0, 0, 0, (0, 0, 64, 64), None, "png"),
             ("hist", 1, {"c": "1"}, 0, 0, 0, (0, 0, 64, 64), None, "json"),
             ("tile", 2, None, 0, 0, 0, (0, 0, 64, 64), None, "png")]
    jax, port = _pipelines(paths)
    try:
        pctx, jctx = _ctxs(lanes)
        got = port.handle_batch(pctx)
        _assert_same(got, jax.handle_batch(jctx), "big-endian")
        assert got[:4] == [None] * 4 and got[4] is not None
        pctx, jctx = _ctxs(lanes[:1])
        assert port.handle(pctx[0]) is None and jax.handle(jctx[0]) is None
    finally:
        jax.close()
        port.close()


class _Fronts:
    """The JAX aiohttp app and the port's server over one registry."""

    async def start(self, paths):
        from aiohttp.test_utils import TestClient, TestServer

        from omero_ms_pixel_buffer_tpu.auth.stores import MemorySessionStore
        from omero_ms_pixel_buffer_tpu.http.server import PixelBufferApp
        from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JR
        from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JS
        from omero_ms_pixel_buffer_tpu.utils.config import Config
        from omero_ms_pixel_buffer_tpu_torch.dispatch.batcher import BatchingTileWorker
        from omero_ms_pixel_buffer_tpu_torch.http.server import TileServer

        jreg, preg = JR(), ImageRegistry()
        for iid, (path, extra) in paths.items():
            jreg.add(iid, path, **extra)
            preg.add(iid, path, **extra)
        config = Config.from_dict({"session-store": {"type": "memory"},
                                   "cache": {"prefetch": {"enabled": False}}})
        self.jax_app = PixelBufferApp(config, pixels_service=JS(jreg),
                                      session_store=MemorySessionStore({"ck": "key1"}))
        self.jax = TestClient(TestServer(self.jax_app.make_app()),
                              loop=asyncio.get_running_loop())
        await self.jax.start_server()
        self.pipeline = port_tp.TilePipeline(PixelsService(preg), buckets=BUCKETS, device="cpu")
        self.port = TileServer(BatchingTileWorker(self.pipeline), sessions={"ck": "key1"})
        self.port_no = await self.port.start("127.0.0.1", 0)
        return self

    async def close(self):
        await self.jax.close()
        await self.port.close()
        self.pipeline.close()

    async def get(self, path):
        r = await self.jax.get(path, headers=COOKIE)
        jax = (r.status, r.headers.get("Retry-After"), await r.read())
        reader, writer = await asyncio.open_connection("127.0.0.1", self.port_no)
        try:
            writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                         f"Cookie: {COOKIE['Cookie']}\r\n\r\n".encode())
            await writer.drain()
            raw = await reader.read()
        finally:
            writer.close()
        top, _, body = raw.partition(b"\r\n\r\n")
        lines = top.decode("latin-1").split("\r\n")
        hdrs = {k.lower(): v for k, v in (ln.split(": ", 1) for ln in lines[1:])}
        return (int(lines[0].split()[1]), hdrs.get("retry-after"), body), jax


async def test_stopped_store_answers_503_with_retry_after_as_jax(tree):
    """An HTTP-served image whose origin stops: every distinct single-chunk
    tile retries and fails (404) until the fifth failure opens the
    store's breaker; then 503 with ``Retry-After`` in both fronts. After
    the origin restarts and the open period passes, tiles serve again."""
    server = _serve_dir(tree, _DirHandler)
    port_no = server.server_address[1]
    paths = {2: (f"http://127.0.0.1:{port_no}/a.zarr", {})}
    fronts = await _Fronts().start(paths)
    try:
        first, jfirst = await fronts.get("/tile/2/0/0/0?x=0&y=0&w=64&h=64&format=png")
        assert first[0] == jfirst[0] == 200 and first[2] == jfirst[2]
        server.shutdown()
        server.server_close()
        seen = []
        for k in range(7):  # one uncached 64x64 chunk each
            path = f"/tile/2/0/1/0?x={64 * (k % 4)}&y={64 * (k // 4)}&w=64&h=64&format=png"
            got, want = await fronts.get(path)
            assert got[:2] == want[:2], (k, got[:2], want[:2])
            seen.append(got[:2])
        assert seen[:5] == [(404, None)] * 5 and seen[5:] == [(503, "30")] * 2
        server = _serve_dir(tree, _DirHandler, port=port_no)
        # the open period has passed
        for b in pbreaker.BOARD._breakers.values():
            b._opened_at -= pbreaker.OPEN_DURATION_S
        for b in jbreaker.BOARD._breakers.values():
            b._opened_at -= b.open_duration_s
        path = "/tile/2/0/1/0?x=0&y=128&w=64&h=64&format=png"
        got, want = await fronts.get(path)
        assert got[0] == want[0] == 200 and got[2] == want[2]
        io_view = fronts.port.health()["io"]
        r = await fronts.jax.get("/healthz")
        jax_io = (await r.json())["io"]
        assert set(jax_io) <= set(io_view)
        assert io_view["issued"] > 0 and io_view["pool"]["hosts"]
        assert fronts.port.health()["breakers"][f"store:http:127.0.0.1:{port_no}"]["state"] \
            == "closed"
    finally:
        await fronts.close()
        server.shutdown()
        server.server_close()


def test_zarr_registry_routing(tree, servers):
    reg = ImageRegistry()
    reg.add(1, os.path.join(tree, "a.zarr"))
    reg.add(2, f"{servers}/b.zarr")
    reg.add(3, f"s3://{_FakeS3Handler.bucket}/c.zarr", type="zarr")
    reg.add(4, "relative/x.zarr", type="zarr")
    assert reg.resolve_path(reg.entry(3)) == f"s3://{_FakeS3Handler.bucket}/c.zarr"
    assert reg.resolve_path(reg.entry(4)) == os.path.join(".", "relative/x.zarr")
    service = PixelsService(reg, device="cpu")
    for iid in (1, 2, 3):
        buf = service.get_pixel_buffer(iid)
        assert isinstance(buf, pzarr.ZarrPixelBuffer) and buf.block_cache is service.block_cache
        data = IMAGES[iid][1]
        assert service.get_pixels(iid).pixels_type == str(data.dtype)
    service.close()


def test_open_breaker_answers_503_on_every_read_route(tree):
    """With the store's breaker open, tile, render, histogram and
    super-tile-less batched reads all answer a 503 marker, as in JAX."""
    server = _serve_dir(tree, _DirHandler)
    paths = {2: (f"http://127.0.0.1:{server.server_address[1]}/a.zarr", {})}
    jax, port = _pipelines(paths)
    lanes = [("tile", 2, None, 0, 0, 0, (128, 0, 64, 64), None, "png"),
             ("tile", 2, None, 1, 1, 0, (64, 64, 64, 64), None, None),
             ("render", 2, {"c": "1,2"}, 0, 0, 0, (0, 0, 64, 64), None, "png"),
             ("hist", 2, {"c": "3"}, 0, 0, 0, (64, 128, 64, 64), None, "json")]
    try:
        # opens the buffer and caches the chunk of (0, 0) in channel 1 only
        pctx, jctx = _ctxs([("tile", 2, None, 0, 0, 0, (0, 0, 64, 64), None, "png")])
        assert port.handle_batch(pctx)[0] == jax.handle_batch(jctx)[0] is not None
        server.shutdown()
        server.server_close()
        for board in (pbreaker.BOARD, jbreaker.BOARD):
            for b in board._breakers.values():
                for _ in range(5):
                    b.record_failure()
        pctx, jctx = _ctxs(lanes)
        got, want = port.handle_batch(pctx), jax.handle_batch(jctx)
        _assert_same(got, want, "open breaker")
        assert all(g.code == 503 and g.retry_after_s > 29 for g in got)
        pctx, jctx = _ctxs(lanes[1:2])
        g, w = port.handle(pctx[0]), jax.handle(jctx[0])
        assert g.code == w.code == 503
    finally:
        jax.close()
        port.close()
        server.server_close()


@pytest.mark.parametrize("kind", ["render", "hist"])
def test_cold_read_past_32_requests_a_tile(tmp_path, kind):
    """The reference's fault, pinned: JAX ``io/fetch.py`` gives its
    requests-per-tile histogram buckets that end at 32.0, so a cold batched
    read issuing more (a full 256² plane of 32² Zarr v3 chunks: 64 store
    requests for one lane) raises inside JAX's ``read_tiles`` and the lane
    answers None. The port answers bytes, equal to JAX's warm answer (its
    chunks cached, no requests issued)."""
    data = _field((1, 2, 1, 256, 256), np.uint16, 41)
    path = str(tmp_path / "fine.zarr")
    write_ngff(path, data, chunks=(32, 32), zarr_format=3, compressor="zlib")
    jax, port = _pipelines({1: (path, {})})
    query = {"c": "1|0:60000$FF0000,2$00FF00"} if kind == "render" else {"c": "1,2"}
    lane = [(kind, 1, query, 0, 0, 0, (0, 0, 0, 0), None, "png" if kind == "render" else "json")]
    try:
        pc, jc = _ctxs(lane)
        assert jax.handle_batch(jc) == [None]  # cold: JAX's histogram raises
        got = port.handle_batch(pc)
        assert isinstance(got[0], bytes)
        pc, jc = _ctxs(lane)
        assert got == jax.handle_batch(jc)  # warm: JAX's bytes
    finally:
        jax.close()
        port.close()
