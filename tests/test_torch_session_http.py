"""The port's front with its session and metadata layers against the JAX
aiohttp app, both built from ONE config file (Redis sessions in ONE RESP
stub, OMERO's metadata plane with per-session ACLs from ONE ``FakePg``,
an image registry for the paths): the same request list goes to both,
and statuses, bodies and the headers both send must be equal. The list:
no cookie, an unknown cookie, a session without a connector, pickled and
signed-JSON sessions (a miss, then hits), a cache hit for a session whose
ACL denies the image (404 in both), OPTIONS, ``/healthz`` (its status:
the bodies differ by design), HEAD of a 403, an invalidation through the
resolver's listener (the next GET ``X-Cache: miss`` in both), and a store
that hangs (503 at ``resilience.io-timeout-ms``) or closes (503 with
``Retry-After``, its breaker opening on the fifth failure). Tolerance:
zero."""

import asyncio
import base64
import json
import pickle
import threading

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from omero_ms_pixel_buffer_tpu.db.metadata import (
    PIXELS_QUERY,
    SESSION_USER_QUERY,
    USER_GROUPS_QUERY,
)
from omero_ms_pixel_buffer_tpu.http.server import PixelBufferApp
from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu.utils.config import Config as JaxConfig
from omero_ms_pixel_buffer_tpu_torch.cache.plane.resp_stub import InMemoryRespServer
from omero_ms_pixel_buffer_tpu_torch.http.server import wire
from omero_ms_pixel_buffer_tpu_torch.io import fetch
from omero_ms_pixel_buffer_tpu_torch.resilience import breaker as pbreaker
from omero_ms_pixel_buffer_tpu_torch.resilience import configure
from omero_ms_pixel_buffer_tpu_torch.utils.config import Config

from test_auth_dispatch import FakeConnector, _django_signed
from test_postgres import FakePg

IMG = np.random.default_rng(12).integers(0, 60000, (1, 1, 2, 256, 256), dtype=np.uint16)
TILE = "/tile/1/0/0/0?x=64&y=0&w=64&h=64&format=png"
COMPARED = ("content-type", "content-disposition", "etag", "cache-control", "x-cache",
            "retry-after", "allow", "content-length")
USERS = {"alice-key": "2", "bob-key": "5", "admin-key": "9"}


def _rows(sql, params):
    if sql == PIXELS_QUERY:
        if params == ["1"]:  # user 2 owns image 1 in private group 3
            return [("1", "256", "256", "1", "2", "1", "uint16", "img", "2", "3", "-120",
                     None, None, None, None)]
        return []
    if sql == SESSION_USER_QUERY:
        return [(USERS[params[0]],)] if params[0] in USERS else []
    if sql == USER_GROUPS_QUERY:
        return {"2": [("3", "f", "lab")], "5": [("3", "f", "lab")],
                "9": [("0", "f", "system")]}.get(params[0], [])
    raise AssertionError(sql)


class _Pg:
    """FakePg on a thread of its own: the resolvers' loop threads reach it
    whatever the test's loop is doing."""

    def __init__(self):
        self.started, self.stop, self.port = threading.Event(), threading.Event(), None
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()
        assert self.started.wait(5)

    def _serve(self):
        loop = asyncio.new_event_loop()

        async def run():
            async with FakePg(rows_for=_rows) as pg:
                self.port = pg.port
                self.started.set()
                while not self.stop.is_set():
                    await asyncio.sleep(0.02)

        try:
            loop.run_until_complete(run())
        finally:
            loop.close()

    def close(self):
        self.stop.set()
        self.thread.join(5)


class Fronts:
    async def start(self, tmp_path):
        self.pg = _Pg()
        path = str(tmp_path / "img.ome.tiff")
        write_ome_tiff(path, IMG, tile_size=(64, 64))
        registry = tmp_path / "registry.json"
        registry.write_text(json.dumps({"images": [{"id": 1, "path": path}]}))
        self.stub = InMemoryRespServer()
        stub_port = await self.stub.start()
        sessions = {
            "pk": base64.b64encode(b"h:" + pickle.dumps({"connector": FakeConnector("alice-key")})),
            "js": _django_signed({"connector": {"omero_session_key": "admin-key"}}),
            "bob": _django_signed({"connector": {"omero_session_key": "bob-key"}}),
            "nc": _django_signed({"_auth_user_id": "4"}),
        }
        for sid, raw in sessions.items():
            self.stub.data[f":1:django.contrib.sessions.cache{sid}".encode()] = (raw, None)
        cfg = tmp_path / "config.yaml"
        cfg.write_text(
            "session-store:\n"
            "  type: redis\n"
            f"  uri: redis://127.0.0.1:{stub_port}/1\n"
            f"image-registry: {registry}\n"
            "omero.server:\n"
            f"  omero.db.uri: postgresql://omero:pw@127.0.0.1:{self.pg.port}/omero\n"
            "resilience:\n"
            "  io-timeout-ms: 300\n"
            "cache:\n"
            "  prefetch:\n"
            "    enabled: false\n")
        self.jax_app = PixelBufferApp(JaxConfig.load(str(cfg)))
        self.jax = TestClient(TestServer(self.jax_app.make_app()),
                              loop=asyncio.get_running_loop())
        await self.jax.start_server()
        self.port = wire(Config.load(str(cfg)), device="cpu")
        self.port_no = await self.port.start("127.0.0.1", 0)
        return self

    async def close(self):
        await self.jax.close()
        await self.jax_app.session_store.close()
        await self.port.close()
        self.port.pipeline.close()
        self.jax_app.pixels_service.metadata_resolver.close_sync()
        self.port.pipeline.pixels_service.metadata_resolver.close_sync()
        self.stub.fail_mode = None
        await self.stub.close()
        self.pg.close()

    async def port_request(self, method, path, headers):
        reader, writer = await asyncio.open_connection("127.0.0.1", self.port_no)
        try:
            head = f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
            for k, v in headers.items():
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

    async def both(self, method, path, cookie=None, body_too=True):
        headers = {"Cookie": f"sessionid={cookie}"} if cookie else {}
        r = await self.jax.request(method, path, headers=headers)
        js, jh, jb = r.status, {k.lower(): v for k, v in r.headers.items()}, await r.read()
        ps, ph, pb = await self.port_request(method, path, headers)
        assert ps == js, (method, path, cookie, ps, js, pb, jb)
        if body_too:
            assert pb == jb, (method, path, cookie)
            for name in COMPARED:
                if name == "content-length" and method == "HEAD" and not jb:
                    continue
                assert ph.get(name) == jh.get(name), (name, method, path, cookie)
        return ps, ph, pb


@pytest.fixture(autouse=True)
def _process_defaults():
    """``wire`` configures process-wide layers: restore the defaults."""
    yield
    default = Config.from_dict({"session-store": {"type": "memory"}})
    configure(default.resilience)
    fetch.configure(default.io)
    pbreaker.BOARD.reset()


async def test_session_request_list_matches_jax(tmp_path):
    f = await Fronts().start(tmp_path)
    try:
        assert (await f.both("GET", TILE))[0] == 403                 # no cookie
        assert (await f.both("GET", TILE, "nosuch"))[0] == 403       # unknown session
        assert (await f.both("GET", TILE, "nc"))[0] == 403           # no connector
        assert (await f.both("HEAD", TILE))[0] == 403                # HEAD of a 403
        assert (await f.both("GET", "/tile/1/0/0/0?x=zz", "nosuch"))[0] == 403
        status, hdrs, body = await f.both("GET", TILE, "pk")        # pickled: a miss
        assert status == 200 and hdrs["x-cache"] == "miss"
        from test_scheduler import _png_pixels

        np.testing.assert_array_equal(_png_pixels(body), IMG[0, 0, 0, 0:64, 64:128])
        assert (await f.both("GET", TILE, "pk"))[1]["x-cache"] == "hit"
        assert (await f.both("GET", TILE, "js"))[1]["x-cache"] == "hit"  # signed JSON, admin
        # a hit whose caller the ACL denies takes the full path: 404
        assert (await f.both("GET", TILE, "bob"))[0] == 404
        assert (await f.both("GET", "/tile/2/0/0/0?format=png", "pk"))[0] == 404
        assert (await f.both("OPTIONS", TILE))[0] == 200
        assert (await f.both("GET", "/healthz", body_too=False))[0] == 200
        assert (await f.both("GET", "/nowhere", "pk"))[0] == 405
        # a changed pixels row: both purge, the next GET renders again
        f.jax_app.pixels_service.metadata_resolver.invalidate(1)
        f.port.pipeline.pixels_service.metadata_resolver.invalidate(1)
        assert (await f.both("GET", TILE, "pk"))[1]["x-cache"] == "miss"
        assert (await f.both("GET", TILE, "pk"))[1]["x-cache"] == "hit"
        # a hanging store: 503 at the I/O timeout, not 403, not the budget
        f.stub.fail_mode = "hang"
        for _ in range(2):
            status, hdrs, body = await f.both("GET", TILE, "pk")
            assert (status, hdrs["retry-after"], body) == (503, "1", b"Session store unavailable")
        f.stub.fail_mode = None
        assert (await f.both("GET", TILE, "pk"))[0] == 200
        # a closing store: 503; the fifth failure opens the breaker
        f.stub.fail_mode = "close"
        retry_after = []
        for _ in range(7):
            status, hdrs, body = await f.both("GET", TILE, "js")
            assert (status, body) == (503, b"Session store unavailable")
            retry_after.append(hdrs["retry-after"])
        assert retry_after[:5] == ["1"] * 5 and retry_after[5:] == ["30", "30"]
        name = next(n for n in f.port.health()["breakers"] if n.startswith("session-store:redis"))
        assert f.port.health()["breakers"][name]["state"] == "open"
        # OPTIONS and /healthz stay ahead of the session check
        assert (await f.both("OPTIONS", TILE))[0] == 200
        assert (await f.both("GET", "/healthz", body_too=False))[0] == 200
    finally:
        await f.close()


async def test_shipped_config_with_redis_down_answers_503(tmp_path):
    """The shipped, unedited config (Redis at localhost:6379, where nothing
    answers here) with a registry: a request with a cookie answers 503,
    not 403; ``/healthz`` lists the five absent planes."""
    import socket

    with socket.socket() as s:
        if s.connect_ex(("127.0.0.1", 6379)) == 0:
            pytest.skip("something answers on localhost:6379")
    path = str(tmp_path / "img.ome.tiff")
    write_ome_tiff(path, IMG, tile_size=(64, 64))
    registry = tmp_path / "registry.json"
    registry.write_text(json.dumps({"images": [{"id": 1, "path": path}]}))
    config = Config.load("conf/config.yaml")
    config.image_registry = str(registry)
    server = wire(config, device="cpu")
    port = await server.start("127.0.0.1", 0)
    try:
        async def get(cookie):
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write((f"GET {TILE} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                          + (f"Cookie: sessionid={cookie}\r\n" if cookie else "")
                          + "\r\n").encode())
            raw = await reader.read()
            writer.close()
            return raw

        raw = await get("someone")
        assert raw.startswith(b"HTTP/1.1 503") and b"Retry-After: 1" in raw
        assert raw.endswith(b"Session store unavailable")
        assert (await get(None)).startswith(b"HTTP/1.1 403")
        assert server.health()["config"]["absent"] == []
    finally:
        await server.close()
        server.pipeline.close()
