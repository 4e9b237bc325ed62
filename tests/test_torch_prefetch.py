"""The port's viewport prefetcher (``cache/prefetch.py``) against the JAX
package's.

``_predict`` in lockstep: the same scripted access streams (made from a
seed with numpy: pans, diagonal moves, zooms, full-plane requests, render
streams, a robot sweep that the sweep detector demotes) through both
prefetchers queue the same predictions (region, level, class, burst grid,
cache key) with the same counts, pruned against the same plane extents.

A pan through both fronts (the JAX aiohttp app and the port's ``wire``,
from one config file, prefetch on as the config has it): after each step
both prefetchers drain, and then both result caches hold the same keys;
every warmed tile answers ``X-Cache: hit`` in both, with equal bodies and
ETags. Tolerance: zero."""

import asyncio
import json

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from omero_ms_pixel_buffer_tpu.auth.stores import MemorySessionStore as JaxMemoryStore
from omero_ms_pixel_buffer_tpu.cache import prefetch as jpf
from omero_ms_pixel_buffer_tpu.http.server import PixelBufferApp
from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxSpec
from omero_ms_pixel_buffer_tpu.resilience import scheduler as jsched
from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx
from omero_ms_pixel_buffer_tpu.utils.config import Config as JaxConfig
from omero_ms_pixel_buffer_tpu_torch.auth.stores import MemorySessionStore
from omero_ms_pixel_buffer_tpu_torch.cache import prefetch as ppf
from omero_ms_pixel_buffer_tpu_torch.http.server import wire
from omero_ms_pixel_buffer_tpu_torch.io import fetch as pfetch
from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
from omero_ms_pixel_buffer_tpu_torch.resilience import breaker as pbreaker
from omero_ms_pixel_buffer_tpu_torch.resilience import configure
from omero_ms_pixel_buffer_tpu_torch.resilience import scheduler as psched
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx
from omero_ms_pixel_buffer_tpu_torch.utils.config import Config

EXTENTS = {(1, None): (1024, 768), (1, 0): (1024, 768), (1, 1): (512, 384), (1, 2): (256, 192)}
RENDER_Q = {"c": "1|0:60000$FF0000,2|0:60000$00FF00"}


class _Cache:
    def __init__(self, held=()):
        self.held = set(held)

    def contains(self, key):
        return key in self.held


class _Admission:
    @staticmethod
    def has_headroom(fraction=0.5):
        return True


def _stream(seed: int):
    """Scripted accesses: (session, x, y, w, h, resolution, render)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(3):
        x, y = int(rng.integers(0, 8)) * 64, int(rng.integers(0, 6)) * 64
        res = (None, 0, 1, 2)[int(rng.integers(0, 4))]
        render = bool(rng.random() < 0.3)
        dx, dy = ((64, 0), (0, 64), (-64, 0), (64, 64))[int(rng.integers(0, 4))]
        for _ in range(int(rng.integers(3, 9))):
            out.append((f"s{s}", x, y, 64, 64, res, render))
            if rng.random() < 0.2:
                dx, dy = -dx, dy
            x, y = x + dx, y + dy
        if rng.random() < 0.3:
            out.append((f"s{s}", 0, 0, 0, 0, res, render))
    for k in range(20):  # a robot: constant stride, demoted past the threshold
        out.append(("robot", 64 * k, 0, 64, 64, 0, False))
    return out


def _make(mod, sched_mod, ctx_cls, region_cls, spec_cls, span, lookahead, held):
    sweep = sched_mod.SweepDetector(threshold=16)
    pf = mod.ViewportPrefetcher(
        fetch=None, cache=_Cache(held), admission=_Admission(), quality="q",
        queue_size=64, lookahead=lookahead, viewport_span=span,
        extent_fn=lambda image, res: EXTENTS.get((image, res)), sweep_detector=sweep)
    spec = spec_cls.from_params(RENDER_Q, default_channel=0)

    def ctx(session, x, y, w, h, res, render):
        return ctx_cls(image_id=1, z=0, c=0, t=0, region=region_cls(x, y, w, h),
                       resolution=res, format="png", omero_session_key=session,
                       render=spec if render else None)
    return pf, sweep, ctx


def _queued(pf):
    out = []
    while not pf._queue.empty():
        c, key = pf._queue.get_nowait()
        r = c.region
        out.append(((r.x, r.y, r.width, r.height), c.resolution, c.priority,
                     None if c.burst is None else (c.burst.tile_w, c.burst.tile_h), key))
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("span,lookahead", [(1, 2), (0, 2), (2, 3)])
def test_predictions_in_lockstep(seed, span, lookahead):
    held = {"img=1|z=0|c=0|t=0|x=128|y=0|w=64|h=64|res=0|fmt=png|q"}
    made = [_make(jpf, jsched, JaxCtx, JaxRegion, JaxSpec, span, lookahead, held),
            _make(ppf, psched, TileCtx, RegionDef, RenderSpec, span, lookahead, held)]
    for access in _stream(seed):
        for pf, sweep, ctx in made:
            c = ctx(*access)
            pf.observe(c)
            r = c.region
            sweep.observe(c.omero_session_key, 1, 0, 0, 0, c.resolution, r.x, r.y,
                          r.width, r.height)
        (jq, pq) = [_queued(pf) for pf, _, _ in made]
        assert pq == jq, access
    assert made[1][0].snapshot() == made[0][0].snapshot()
    assert made[1][0].snapshot()["suppressed_sweep"] > 0


def test_invalidate_drops_memoized_extents():
    calls = []
    pf = ppf.ViewportPrefetcher(None, _Cache(), _Admission(),
                                extent_fn=lambda i, r: calls.append(i) or (1024, 768))
    assert pf._extent(1, 0) == (1024, 768) and pf._extent(1, 0) == (1024, 768)
    assert calls == [1]
    pf.invalidate_image(1)
    pf._extent(1, 0)
    assert calls == [1, 1]


# -- a pan through both fronts ------------------------------------------------------

IMG = np.random.default_rng(33).integers(0, 60000, (1, 3, 1, 384, 768), dtype=np.uint16)
COOKIE = {"Cookie": "sessionid=ck"}
PANS = {
    "tile": "/tile/1/0/0/0?x={x}&y={y}&w=64&h=64&format=png",
    "render": "/render/1/0/0/0?x={x}&y={y}&w=64&h=64&c=1|0:60000$FF0000,2|0:60000$00FF00",
}


@pytest.fixture
def _process_defaults():
    """``wire`` configures process-wide layers: restore the defaults."""
    yield
    default = Config.from_dict({"session-store": {"type": "memory"}})
    configure(default.resilience)
    pfetch.configure(default.io)
    pbreaker.BOARD.reset()


def _keys(cache):
    mem = cache.memory
    return set(mem._probation) | set(mem._protected)


@pytest.mark.parametrize("kind", sorted(PANS))
async def test_pan_warms_the_same_tiles_as_jax(tmp_path, kind, _process_defaults):
    path = str(tmp_path / "img.ome.tiff")
    write_ome_tiff(path, IMG, tile_size=(64, 64))
    registry = tmp_path / "registry.json"
    registry.write_text(json.dumps({"images": [{"id": 1, "path": path}]}))
    cfg = tmp_path / "config.yaml"
    cfg.write_text(f"session-store:\n  type: memory\nimage-registry: {registry}\n")
    jax_app = PixelBufferApp(JaxConfig.load(str(cfg)),
                             session_store=JaxMemoryStore({"ck": "key1"}))
    jax = TestClient(TestServer(jax_app.make_app()), loop=asyncio.get_running_loop())
    await jax.start_server()
    port = wire(Config.load(str(cfg)), session_store=MemorySessionStore({"ck": "key1"}),
                device="cpu")
    assert port.prefetcher is not None and jax_app.prefetcher is not None
    port_no = await port.start("127.0.0.1", 0)

    async def port_get(url):
        reader, writer = await asyncio.open_connection("127.0.0.1", port_no)
        try:
            writer.write(f"GET {url} HTTP/1.1\r\nHost: x\r\nCookie: sessionid=ck\r\n"
                         "Connection: close\r\n\r\n".encode())
            await writer.drain()
            raw = await reader.read()
        finally:
            writer.close()
        top, _, body = raw.partition(b"\r\n\r\n")
        lines = top.decode("latin-1").split("\r\n")
        hdrs = {k.lower(): v for k, v in (ln.split(": ", 1) for ln in lines[1:])}
        return int(lines[0].split()[1]), hdrs, body

    async def both(url):
        r = await jax.request("GET", url, headers=COOKIE)
        jh = {k.lower(): v for k, v in r.headers.items()}
        js, jb = r.status, await r.read()
        ps, ph, pb = await port_get(url)
        assert (ps, pb) == (js, jb), url
        for name in ("etag", "x-cache", "content-type"):
            assert ph.get(name) == jh.get(name), (name, url)
        return ps, ph

    async def drained():
        idle = 0
        for _ in range(3000):
            busy = (jax_app.prefetcher._queue.qsize() or port.prefetcher._queue.qsize()
                    or jax_app.bus._flights._flights or port._flight._flights)
            idle = 0 if busy else idle + 1
            if idle >= 3:
                return
            await asyncio.sleep(0.01)
        raise AssertionError("prefetchers did not drain")

    try:
        y = 128
        for step in range(6):
            await both(PANS[kind].format(x=64 * step, y=y))
            await drained()
            assert _keys(port.cache) == _keys(jax_app.result_cache), step
        jsnap, psnap = jax_app.prefetcher.snapshot(), port.prefetcher.snapshot()
        assert psnap == jsnap
        assert psnap["warmed"] > 0 and psnap["failed"] == 0
        # the predicted next column and its neighbours, never requested;
        # each hit is observed too, so both fronts drain after each
        for dx, dy in ((6, 0), (7, 0), (6, -1), (6, 1)):
            status, hdrs = await both(PANS[kind].format(x=64 * dx, y=y + 64 * dy))
            assert (status, hdrs["x-cache"]) == (200, "hit")
            await drained()
        health = json.loads((await port_get("/healthz"))[2])
        assert health["prefetch"] == port.prefetcher.snapshot() == jax_app.prefetcher.snapshot()
        assert _keys(port.cache) == _keys(jax_app.result_cache)
    finally:
        await jax.close()
        await port.close()
        port.pipeline.close()


async def test_failed_prefetch_is_counted_and_serves_no_body(tmp_path):
    """A prefetch whose render fails is counted ``failed`` (and in
    ``tile_prefetch_total``), caches nothing, and the real request for
    that tile renders it afresh (``X-Cache: miss``, the right bytes)."""
    from omero_ms_pixel_buffer_tpu_torch.errors import InternalError
    from omero_ms_pixel_buffer_tpu_torch.http.server import create_server

    path = str(tmp_path / "img.ome.tiff")
    write_ome_tiff(path, IMG, tile_size=(64, 64))
    registry = tmp_path / "registry.json"
    registry.write_text(json.dumps({"images": [{"id": 1, "path": path}]}))
    server = create_server(str(registry), dev=True, device="cpu", packer="scan",
                           prefetch=True)
    real_handle = server.worker.handle

    async def handle(ctx):
        if ctx.priority == psched.PRIORITY_PREFETCH:
            raise InternalError("injected prefetch fault")
        return await real_handle(ctx)

    server.worker.handle = handle
    failed = ppf.PREFETCH._values.get((("outcome", "failed"),), 0.0)
    port_no = await server.start("127.0.0.1", 0)

    async def get(url):
        reader, writer = await asyncio.open_connection("127.0.0.1", port_no)
        writer.write(f"GET {url} HTTP/1.1\r\nHost: x\r\nCookie: sessionid=d\r\n"
                     "Connection: close\r\n\r\n".encode())
        await writer.drain()
        raw = await reader.read()
        writer.close()
        top, _, body = raw.partition(b"\r\n\r\n")
        return top.decode("latin-1"), body

    try:
        for x in (0, 64):
            assert (await get(PANS["tile"].format(x=x, y=128)))[0].startswith("HTTP/1.1 200")
        for _ in range(3000):
            if server.prefetcher.snapshot()["failed"] and not server.prefetcher._queue.qsize() \
                    and not server._flight._flights:
                break
            await asyncio.sleep(0.01)
        else:
            raise AssertionError("the prefetcher did not drain")
        snap = server.prefetcher.snapshot()
        assert snap["failed"] > 0 and snap["warmed"] == 0
        assert ppf.PREFETCH._values[(("outcome", "failed"),)] == failed + snap["failed"]
        assert len(server.cache.memory) == 2  # the two real tiles alone
        head, body = await get(PANS["tile"].format(x=128, y=128))
        assert "X-Cache: miss" in head
        server.worker.handle = real_handle
        import io

        from PIL import Image

        np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(body))),
                                      IMG[0, 0, 0, 128:192, 128:192])
    finally:
        await server.close()
        server.pipeline.close()


@pytest.mark.parametrize("headroom", [False, True], ids=["busy", "idle"])
async def test_worker_sheds_without_headroom_like_jax(headroom):
    """Speculative work sheds first: with real traffic over the headroom
    every queued prediction is shed (counted, never fetched); with
    headroom each is fetched once, in the same order, by both packages."""

    class Admission:
        @staticmethod
        def has_headroom(fraction=0.5):
            return headroom

    fetched = {"jax": [], "port": []}
    made = []
    for name, mod, ctx_cls, region_cls in (("jax", jpf, JaxCtx, JaxRegion),
                                           ("port", ppf, TileCtx, RegionDef)):
        async def fetch(ctx, key, name=name):
            fetched[name].append(key)

        pf = mod.ViewportPrefetcher(fetch, _Cache(), Admission(), quality="q",
                                    extent_fn=lambda i, r: (1024, 768))
        pf.start()
        for x in (0, 64, 128):
            pf.observe(ctx_cls(image_id=1, z=0, c=0, t=0, region=region_cls(x, 64, 64, 64),
                               resolution=0, format="png", omero_session_key="s"))
        made.append(pf)
    for _ in range(200):
        if all(pf._queue.empty() for pf in made):
            break
        await asyncio.sleep(0.01)
    await asyncio.sleep(0.05)
    snaps = [pf.snapshot() for pf in made]
    for pf in made:
        await pf.close()
    assert snaps[1] == snaps[0]
    assert fetched["port"] == fetched["jax"]
    if headroom:
        assert snaps[1]["warmed"] == len(fetched["port"]) > 0 and snaps[1]["shed"] == 0
    else:
        assert snaps[1]["shed"] > 0 and snaps[1]["warmed"] == 0 and not fetched["port"]
