"""The session plane through the port's front against the JAX aiohttp app,
both built from one config on one OME-TIFF (made from a seed with numpy)
and driven by one aiohttp client.

- **Protocol.** The SSE byte stream (de-chunked) and the WebSocket frames
  (as text) are equal: the hello, deltas, an annotation write's
  ``invalidate`` then ``annotations``, the revocation close. aiohttp's
  ``ws_connect`` also checks the port's handshake as a real client, once
  offering ``permessage-deflate`` (JAX accepts it, the port declines it:
  the frames' text is still equal). Handshake refusals answer JAX's 400s.
- **Annotations.** CRUD statuses, bodies and headers are equal under one
  injected clock: 201/200, the grammar's 400s, a body that is not JSON,
  one over 1 MiB (JAX's handler swallows aiohttp's 413 and answers 400),
  404s, the full table's refusal, 405 with ``Allow``.
- **Overlay.** ``/render?annotations=1`` bodies and ETags equal JAX's and
  the port's own explicit ``roi=`` request (which is then a cache hit),
  with the joined set cut at 64 shapes.
- **Viewport.** ``POST /session/{id}/viewport`` answers are equal, with
  the prefetcher on and off.
- **Edges.** 403 without a cookie; 503 at capacity; a revoked session's
  channel closes within two ping intervals; a dropped socket leaves no
  pump task and no channel.
- **Other surfaces.** ``/healthz`` ``session``, Iris metadata with its
  ``capabilities``, and ``/debug/requests`` listing ``/session/push``.

Tolerance: zero."""

import asyncio
import base64
import json
import os
import struct

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from omero_ms_pixel_buffer_tpu.auth.stores import MemorySessionStore as JaxMemoryStore
from omero_ms_pixel_buffer_tpu.http.server import PixelBufferApp
from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu.utils.config import Config as JaxConfig
from omero_ms_pixel_buffer_tpu_torch.auth.stores import MemorySessionStore
from omero_ms_pixel_buffer_tpu_torch.http import websocket
from omero_ms_pixel_buffer_tpu_torch.http.server import wire
from omero_ms_pixel_buffer_tpu_torch.io import fetch as pfetch
from omero_ms_pixel_buffer_tpu_torch.resilience import breaker as pbreaker
from omero_ms_pixel_buffer_tpu_torch.resilience import configure
from omero_ms_pixel_buffer_tpu_torch.utils.config import Config

IMG = np.random.default_rng(44).integers(0, 4096, (1, 2, 1, 192, 256), dtype=np.uint16)
COOKIE = {"Cookie": "sessionid=ck"}
RECT = {"type": "rect", "x": 8, "y": 8, "w": 24, "h": 16}
CLOCK = 1.7e9
RENDER = "/render/1/0/0/0?x=0&y=0&w=128&h=128&c=1|0:4000$FF0000,2|0:4000$00FF00"


@pytest.fixture
def _process_defaults():
    """``wire`` configures process-wide layers: restore the defaults."""
    yield
    default = Config.from_dict({"session-store": {"type": "memory"}})
    configure(default.resilience)
    pfetch.configure(default.io)
    pbreaker.BOARD.reset()


class Fronts:
    """The JAX app (aiohttp test server) and the port (``wire``) from one
    config dict, each with its annotation clock fixed at ``CLOCK``."""

    async def start(self, tmp_path, extra=None, sessions=None):
        path = str(tmp_path / "img.ome.tiff")
        write_ome_tiff(path, IMG, tile_size=(64, 64))
        registry = tmp_path / "registry.json"
        registry.write_text(json.dumps({"images": [{"id": 1, "path": path}]}))
        raw = {"session-store": {"type": "memory"}, "image-registry": str(registry),
               "cache": {"prefetch": {"enabled": False}}}
        for block, value in (extra or {}).items():
            raw[block] = {**raw.get(block, {}), **value}
        sessions = sessions or {"ck": "key1"}
        self.jax_store = JaxMemoryStore(dict(sessions))
        self.jax_app = PixelBufferApp(JaxConfig.from_dict(raw), session_store=self.jax_store)
        self.jax = TestClient(TestServer(self.jax_app.make_app()),
                              loop=asyncio.get_running_loop())
        await self.jax.start_server()
        self.port_store = MemorySessionStore(dict(sessions))
        self.port = wire(Config.from_dict(raw), session_store=self.port_store, device="cpu")
        self.port_no = await self.port.start("127.0.0.1", 0)
        for store in (self.jax_app.annotations, self.port.annotations):
            if store is not None:
                store._clock = lambda: CLOCK
        self.http = aiohttp.ClientSession()
        return self

    def urls(self, path):
        return str(self.jax.make_url(path)), f"http://127.0.0.1:{self.port_no}{path}"

    async def both(self, method, path, headers=COOKIE, **kw):
        """[(status, headers, body)] of JAX then the port."""
        out = []
        for url in self.urls(path):
            async with self.http.request(method, url, headers=headers, **kw) as r:
                out.append((r.status, r.headers, await r.read()))
        return out

    async def close(self):
        await self.http.close()
        await self.jax.close()
        await self.port.close()
        self.port.pipeline.close()


async def _fronts(tmp_path, body, **kw):
    f = await Fronts().start(tmp_path, **kw)
    try:
        await body(f)
    finally:
        await f.close()


def _same(answers, *names):
    """The two answers' status, body and the named headers are equal."""
    (js, jh, jb), (ps, ph, pb) = answers
    assert (ps, pb) == (js, jb)
    for name in names:
        assert ph.get(name) == jh.get(name), name
    return js, jb


async def _recv(ws, timeout=10.0):
    while True:
        msg = await asyncio.wait_for(ws.receive(), timeout)
        if msg.type != aiohttp.WSMsgType.PONG:
            return msg


async def _next_sse(resp, timeout=10.0) -> bytes:
    """The next event's bytes (``data: ...\\n\\n``), or b"" at EOF."""
    out = b""
    while True:
        line = await asyncio.wait_for(resp.content.readline(), timeout)
        out += line
        if line in (b"\n", b""):
            return out


async def _until(cond, timeout=10.0):
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while not cond():
        assert loop.time() < end, "condition not reached"
        await asyncio.sleep(0.01)


def _pump_tasks():
    """The port's live-channel tasks still alive."""
    return [t for t in asyncio.all_tasks()
            if "pump_then_close" in repr(t.get_coro()) and not t.done()]


def _channel(app_registry):
    (channel,) = app_registry._channels.values()
    return channel


# -- protocol -----------------------------------------------------------------------

async def test_sse_stream_matches_jax(tmp_path, _process_defaults):
    """Hello, a pushed delta, an annotation write's two frames and the
    revocation close, then the chunked EOF: equal bytes and headers."""
    async def body(f):
        streams, regs = [], (f.jax_app.session_channels, f.port.session_channels)
        for url in f.urls("/session/1/live"):
            resp = await f.http.get(url, headers=COOKIE)
            assert resp.status == 200
            streams.append(resp)
        try:
            (jr, pr) = streams
            for name in ("Content-Type", "Cache-Control", "X-Accel-Buffering",
                         "Transfer-Encoding"):
                assert pr.headers.get(name) == jr.headers.get(name), name
            assert [await _next_sse(r) for r in streams] == [
                b'data: {"type":"hello","image":1,"transport":"sse","epoch":null,'
                b'"annotations":0}\n\n'] * 2
            for reg in regs:
                reg.push_delta(1, epoch=7, tiles=("t1",))
            got = [await _next_sse(r) for r in streams]
            assert got[1] == got[0] == (b'data: {"type":"invalidate","image":1,'
                                        b'"tiles":["t1"],"epoch":7}\n\n')
            _same(await f.both("POST", "/annotations/1", json={"shape": RECT}))
            got = [[await _next_sse(r) for _ in range(2)] for r in streams]
            assert got[1] == got[0]
            assert [json.loads(e[6:])["type"] for e in got[1]] == ["invalidate", "annotations"]
            for reg in regs:
                reg.revoke(_channel(reg))
            rest = [await asyncio.wait_for(r.content.read(), 10) for r in streams]
            assert rest[1] == rest[0] == b'data: {"type":"close","reason":"revoked"}\n\n'
            assert all(r.content.at_eof() for r in streams)
        finally:
            for r in streams:
                r.close()
        await _until(lambda: f.port.session_channels.snapshot()["live"] == 0)
    await _fronts(tmp_path, body)


@pytest.mark.parametrize("compress", [0, 15], ids=["plain", "deflate-offered"])
async def test_websocket_frames_match_jax(tmp_path, compress, _process_defaults):
    """The hello, a ping answered, a viewport frame noted (and dropped by
    the purge of an annotation write), the write's two frames and a client
    close, through aiohttp's client against
    both: equal frame texts; the port declines ``permessage-deflate``."""
    async def body(f):
        socks = [await f.http.ws_connect(url, headers=COOKIE, compress=compress)
                 for url in f.urls("/session/1/live")]
        jws, pws = socks
        assert jws.compress == compress and pws.compress == 0
        hello = [await _recv(ws) for ws in socks]
        assert [m.data for m in hello] == [json.dumps(
            {"type": "hello", "image": 1, "transport": "ws", "epoch": None,
             "annotations": 0})] * 2
        for ws in socks:
            await ws.ping(b"are you there")
            await ws.send_str(json.dumps({"type": "viewport", "x": 0, "y": 0, "w": 128,
                                          "h": 64}))
            await ws.send_str("not json")
        for app in (f.jax_app, f.port):
            await _until(lambda: ("key1", 1) in app.prefetcher._viewports)
            assert app.prefetcher._viewports[("key1", 1)]["w"] == 128
        _same(await f.both("POST", "/annotations/1", json={"shape": RECT, "label": "x"}))
        frames = [[(await _recv(ws)).data for _ in range(2)] for ws in socks]
        assert frames[1] == frames[0]
        assert [json.loads(t)["type"] for t in frames[1]] == ["invalidate", "annotations"]
        assert json.loads(frames[1][1]) == {"type": "annotations", "image": 1, "tiles": [],
                                            "epoch": None, "annotations": 1}
        for app in (f.jax_app, f.port):  # the write's purge drops the image's viewports
            assert ("key1", 1) not in app.prefetcher._viewports
        for ws in socks:
            await ws.close()
            assert ws.closed
        await _until(lambda: f.port.session_channels.snapshot()["live"] == 0)
        assert not _pump_tasks()
    await _fronts(tmp_path, body, extra={"cache": {"prefetch": {"enabled": True}}})


@pytest.mark.parametrize("drop,value", [
    ("connection", None), ("sec-websocket-version", "12"), ("sec-websocket-key", None),
    ("sec-websocket-key", "c2hvcnQ="),
])
async def test_websocket_handshake_refusals_match_jax(tmp_path, drop, value,
                                                      _process_defaults):
    """A refused handshake answers JAX's 400 and its text, and leaves no
    channel registered."""
    async def body(f):
        headers = {**COOKIE, "Upgrade": "websocket", "Connection": "Upgrade",
                   "Sec-WebSocket-Version": "13",
                   "Sec-WebSocket-Key": base64.b64encode(os.urandom(16)).decode()}
        if value is None:
            headers.pop(next(k for k in headers if k.lower() == drop))
        else:
            headers[next(k for k in headers if k.lower() == drop)] = value
        status, _ = _same(await f.both("GET", "/session/1/live", headers=headers),
                          "Content-Type")
        assert status == 400
        assert f.port.session_channels.snapshot()["live"] == 0
    await _fronts(tmp_path, body)


def test_accept_value_is_rfc6455s():
    """The RFC 6455 section 1.3 example."""
    assert websocket.accept_value("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


async def test_fragmented_masked_frames_and_binary(tmp_path, _process_defaults):
    """A raw client: a text message in three masked fragments with a ping
    between them reaches the prefetcher; a binary message is dropped; an
    unmasked frame is a protocol error (close 1002)."""
    async def body(f):
        reader, writer = await asyncio.open_connection("127.0.0.1", f.port_no)
        key = base64.b64encode(os.urandom(16)).decode()
        writer.write(("GET /session/1/live HTTP/1.1\r\nHost: x\r\nCookie: sessionid=ck\r\n"
                      "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
        head = await reader.readuntil(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 101 ")
        assert f"Sec-WebSocket-Accept: {websocket.accept_value(key)}".encode() in head
        assert b"Sec-WebSocket-Extensions" not in head

        def masked(op, payload, fin=True):
            mask = os.urandom(4)
            data = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
            return struct.pack(">BB", (0x80 if fin else 0) | op, 0x80 | len(payload)) + mask + data

        async def frame():
            b0, b1 = await reader.readexactly(2)
            n = b1 & 0x7F
            if n == 126:
                (n,) = struct.unpack(">H", await reader.readexactly(2))
            return b0 & 0x0F, await reader.readexactly(n)

        assert json.loads((await frame())[1])["type"] == "hello"
        text = json.dumps({"type": "viewport", "x": 64, "y": 0, "w": 64, "h": 64}).encode()
        writer.write(masked(websocket.OP_TEXT, text[:10], fin=False)
                     + masked(websocket.OP_CONTINUATION, text[10:20], fin=False)
                     + masked(websocket.OP_PING, b"p")
                     + masked(websocket.OP_CONTINUATION, text[20:])
                     + masked(websocket.OP_BINARY, b"\x00\x01"))
        assert await frame() == (websocket.OP_PONG, b"p")
        await _until(lambda: ("key1", 1) in f.port.prefetcher._viewports)
        assert f.port.prefetcher._viewports[("key1", 1)]["x"] == 64
        writer.write(struct.pack(">BB", 0x81, 1) + b"x")  # unmasked
        assert await frame() == (websocket.OP_CLOSE, struct.pack(">H", 1002))
        await _until(lambda: f.port.session_channels.snapshot()["live"] == 0)
        writer.close()
    await _fronts(tmp_path, body, extra={"cache": {"prefetch": {"enabled": True}}})


# -- annotations --------------------------------------------------------------------

ANNOTATION_STEPS = [
    ("POST", "/annotations/1", {"json": {"shape": RECT, "label": "tumor"}}),
    ("POST", "/annotations/1", {"json": {"type": "ellipse", "cx": 60, "cy": 40, "rx": 9,
                                         "ry": 5}}),
    ("POST", "/annotations/1", {"json": {"shape": {"type": "hexagon"}}}),
    ("POST", "/annotations/1", {"json": {"shape": RECT, "label": 7}}),
    ("POST", "/annotations/1", {"json": {"shape": [1, 2]}}),
    ("POST", "/annotations/1", {"json": [RECT]}),
    ("POST", "/annotations/1", {"data": b"{not json"}),
    ("POST", "/annotations/1", {"data": b""}),
    ("POST", "/annotations/1", {"data": b" " * ((1 << 20) + 1)}),
    ("POST", "/annotations/x", {"json": {"shape": RECT}}),
    ("GET", "/annotations/1", {}),
    ("HEAD", "/annotations/1", {}),
    ("GET", "/annotations/2", {}),
    ("GET", "/annotations/1/a1", {}),
    ("GET", "/annotations/1/a9", {}),
    ("PUT", "/annotations/1/a1", {"json": {"shape": {**RECT, "w": 40}}}),
    ("PUT", "/annotations/1/a2", {"json": {"type": "polygon", "points": [[1, 1], [30, 2], [9, 20]],
                                           "label": "kept"}}),
    ("PUT", "/annotations/1/a9", {"json": {"shape": RECT}}),
    ("PUT", "/annotations/1/a1", {"data": b"[]"}),
    ("PUT", "/annotations/1/a1", {"json": {"shape": {**RECT, "w": -1}}}),
    ("DELETE", "/annotations/1/a2", {}),
    ("DELETE", "/annotations/1/a2", {}),
    ("DELETE", "/annotations/x/a1", {}),
    ("PATCH", "/annotations/1/a1", {}),
    ("PUT", "/annotations/1", {}),
    ("GET", "/session/1/viewport", {}),
    ("POST", "/session/1/live", {}),
    ("GET", "/session/x/live", {}),
    ("GET", "/annotations/1/a1/more", {}),
    ("POST", "/annotations/1", {"json": {"shape": RECT}}),
    ("POST", "/annotations/1", {"json": {"shape": RECT}}),
    ("GET", "/annotations/1", {}),
]


async def test_annotation_crud_matches_jax(tmp_path, _process_defaults):
    """Every step of a CRUD sequence answers equal status, body,
    Content-Type and Allow; the table holds 2 (the last create is
    refused)."""
    async def body(f):
        statuses = []
        for method, path, kw in ANNOTATION_STEPS:
            status, _ = _same(await f.both(method, path, **kw), "Content-Type", "Allow")
            statuses.append(status)
        assert statuses.count(201) == 3 and 404 in statuses and 405 in statuses
        assert statuses[8] == 400 and statuses[-2] == 400  # oversize body; table full
        (_, _, jb), (_, _, pb) = await f.both("GET", "/healthz")
        assert json.loads(pb)["session"] == json.loads(jb)["session"]
    await _fronts(tmp_path, body, extra={"session": {"max-annotations-per-image": 2}})


async def test_healthz_session_matches_jax(tmp_path, _process_defaults):
    """``/healthz`` ``session`` after channels, pushes, a capacity refusal
    and annotation writes."""
    async def body(f):
        streams = [await f.http.get(url, headers=COOKIE) for url in f.urls("/session/1/live")]
        for r in streams:
            await _next_sse(r)
        _same(await f.both("GET", "/session/1/live"))  # the third: 503 at max-per-image 1
        _same(await f.both("POST", "/annotations/1", json={"shape": RECT}))
        _same(await f.both("DELETE", "/annotations/1/a1"))
        for r in streams:
            for _ in range(4):
                await _next_sse(r)
            r.close()
        await _until(lambda: f.port.session_channels.snapshot()["live"] == 0)
        await _until(lambda: f.jax_app.session_channels.snapshot()["live"] == 0)
        (_, _, jb), (_, _, pb) = await f.both("GET", "/healthz")
        jsession, psession = json.loads(jb)["session"], json.loads(pb)["session"]
        assert psession == jsession
        assert psession["rejected_full"] == 1 and psession["annotation_pushes"] == 2
        assert psession["annotations"]["deleted"] == 1
    await _fronts(tmp_path, body, extra={"session": {"max-per-image": 1}})


# -- overlay ------------------------------------------------------------------------

def _roi(shapes):
    return "&roi=" + json.dumps(shapes, separators=(",", ":"))


@pytest.mark.parametrize("explicit", [0, 1, 63], ids=["stored-only", "roi-first", "cut-at-64"])
async def test_overlay_matches_jax_and_the_explicit_roi(tmp_path, explicit, _process_defaults):
    """``annotations=1`` joins the stored shapes after the explicit ones:
    the body and ETag equal JAX's, and the port's explicit ``roi=`` request
    with the joined (cut) set answers the same bytes from the cache."""
    async def body(f):
        stored = [RECT, {"type": "ellipse", "cx": 90, "cy": 70, "rx": 20, "ry": 11},
                  {"type": "polygon", "points": [[100, 5], [127, 40], [70, 30]]}]
        for shape in stored:
            _same(await f.both("POST", "/annotations/1", json={"shape": shape}))
        roi = [{"type": "rect", "x": i % 100, "y": i, "w": 3, "h": 2}
               for i in range(explicit)]
        url = RENDER + (_roi(roi) if roi else "") + "&annotations=1"
        _, overlay = _same(await f.both("GET", url), "ETag", "X-Cache", "Content-Type")
        (_, jh, _), (_, ph, _) = await f.both("GET", url)
        assert ph["ETag"] == jh["ETag"] and ph["X-Cache"] == "hit"
        joined = (roi + stored)[:64]
        (_, _, jplain), (_, _, plain) = await f.both("GET", RENDER)
        assert overlay != plain
        _, explicit_hdrs, explicit_body = (await f.both("GET", RENDER + _roi(joined)))[1]
        assert explicit_body == overlay and explicit_hdrs["ETag"] == ph["ETag"]
        assert explicit_hdrs["X-Cache"] == "hit"
    await _fronts(tmp_path, body)


async def test_overlay_without_annotations_is_the_plain_render(tmp_path, _process_defaults):
    async def body(f):
        (_, _, jb), (_, ph, pb) = await f.both("GET", RENDER + "&annotations=true")
        assert pb == jb
        assert (await f.both("GET", RENDER))[1][1]["X-Cache"] == "hit"
    await _fronts(tmp_path, body)


# -- viewport -----------------------------------------------------------------------

VIEWPORT_BODIES = [
    {"json": {"x": 0, "y": 0, "w": 256, "h": 128}},
    {"json": {"x": 64, "y": 0, "w": 128, "h": 64, "zoom": 0}},
    {"json": {"x": 0, "y": 0, "w": 0, "h": 64}},
    {"json": {"x": -1, "y": 0, "w": 8, "h": 8}},
    {"json": {"x": 0, "y": 0, "w": 8, "h": 8, "zoom": "deep"}},
    {"json": {"x": "a", "y": 0, "w": 8, "h": 8}},
    {"json": [1, 2, 3]},
    {"data": b"{"},
]


@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch", "no-prefetch"])
async def test_viewport_answers_match_jax(tmp_path, prefetch, _process_defaults):
    async def body(f):
        for kw in VIEWPORT_BODIES:
            _same(await f.both("POST", "/session/1/viewport", **kw), "Content-Type")
        _same(await f.both("POST", "/session/one/viewport", json={"x": 0}))
        if prefetch:
            assert (f.port.prefetcher._viewports[("key1", 1)]
                    == f.jax_app.prefetcher._viewports[("key1", 1)])
    await _fronts(tmp_path, body, extra={"cache": {"prefetch": {"enabled": prefetch}}})


# -- session edges ------------------------------------------------------------------

SESSION_ROUTES = [("GET", "/session/1/live"), ("POST", "/session/1/viewport"),
                  ("GET", "/annotations/1"), ("POST", "/annotations/1"),
                  ("GET", "/annotations/1/a1"), ("PUT", "/annotations/1/a1"),
                  ("DELETE", "/annotations/1/a1")]


@pytest.mark.parametrize("cookie", [None, "who-is-this"], ids=["no-cookie", "unknown"])
async def test_routes_need_a_session(tmp_path, cookie, _process_defaults):
    async def body(f):
        headers = {"Cookie": f"sessionid={cookie}"} if cookie else {}
        for method, path in SESSION_ROUTES:
            status, _ = _same(await f.both(method, path, headers=headers))
            assert status == 403, (method, path)
    await _fronts(tmp_path, body)


async def test_capacity_answers_503(tmp_path, _process_defaults):
    """Past ``max-channels`` (either transport): 503, ``Retry-After: 1``."""
    async def body(f):
        held = [await f.http.get(url, headers=COOKIE) for url in f.urls("/session/1/live")]
        for r in held:
            await _next_sse(r)
        answers = await f.both("GET", "/session/2/live")
        _same(answers, "Retry-After")
        assert answers[1][0] == 503 and answers[1][1]["Retry-After"] == "1"
        assert answers[1][2] == b"Session plane at capacity"
        for url in f.urls("/session/1/live"):
            with pytest.raises(aiohttp.WSServerHandshakeError) as e:
                await f.http.ws_connect(url, headers=COOKIE)
            assert e.value.status == 503
        for r in held:
            r.close()
    await _fronts(tmp_path, body, extra={"session": {"max-channels": 1}})


@pytest.mark.parametrize("transport", ["ws", "sse"])
async def test_revoked_session_closes_within_two_intervals(tmp_path, transport,
                                                           _process_defaults):
    """With ``ping-interval-s`` 0.5, a quiet interval first pings; after the
    session leaves the store the channel gets the revocation close within
    two intervals, then ends, in both fronts."""
    async def body(f):
        loop = asyncio.get_running_loop()
        for i, url in enumerate(f.urls("/session/1/live")):
            store = (f.jax_store, f.port_store)[i]
            if transport == "ws":
                ws = await f.http.ws_connect(url, headers=COOKIE)
                assert json.loads((await _recv(ws)).data)["type"] == "hello"
                assert json.loads((await _recv(ws)).data) == {"type": "ping", "epoch": None}
                store.sessions.pop("ck")
                t0 = loop.time()
                assert json.loads((await _recv(ws)).data) == {"type": "close",
                                                              "reason": "revoked"}
                assert loop.time() - t0 < 1.0
                assert (await _recv(ws)).type in (aiohttp.WSMsgType.CLOSE,
                                                  aiohttp.WSMsgType.CLOSED)
                await ws.close()
            else:
                r = await f.http.get(url, headers=COOKIE)
                await _next_sse(r)
                assert await _next_sse(r) == b'data: {"type":"ping","epoch":null}\n\n'
                store.sessions.pop("ck")
                t0 = loop.time()
                assert await _next_sse(r) == b'data: {"type":"close","reason":"revoked"}\n\n'
                assert loop.time() - t0 < 1.0
                assert await _next_sse(r) == b""
                r.close()
            store.sessions["ck"] = "key1"
        assert (f.port.session_channels.snapshot()["revoked"]
                == f.jax_app.session_channels.snapshot()["revoked"] == 1)
    await _fronts(tmp_path, body, extra={"session": {"ping-interval-s": 0.5}})


@pytest.mark.parametrize("transport", ["ws", "sse"])
async def test_dropped_socket_leaves_no_pump(tmp_path, transport, _process_defaults):
    """A client that vanishes (its socket aborted, no close frame) leaves
    no channel and no pump task behind, long before a ping would notice."""
    async def body(f):
        reader, writer = await asyncio.open_connection("127.0.0.1", f.port_no)
        head = "GET /session/1/live HTTP/1.1\r\nHost: x\r\nCookie: sessionid=ck\r\n"
        if transport == "ws":
            head += ("Upgrade: websocket\r\nConnection: Upgrade\r\nSec-WebSocket-Version: 13\r\n"
                     f"Sec-WebSocket-Key: {base64.b64encode(os.urandom(16)).decode()}\r\n")
        writer.write((head + "\r\n").encode())
        await reader.readuntil(b"\r\n\r\n")
        await _until(lambda: f.port.session_channels.snapshot()["live"] == 1)
        writer.transport.abort()
        await _until(lambda: f.port.session_channels.snapshot()["live"] == 0)
        await _until(lambda: not _pump_tasks() and not f.port._live)
    await _fronts(tmp_path, body, extra={"session": {"ping-interval-s": 30}})


# -- other surfaces -----------------------------------------------------------------

@pytest.mark.parametrize("enabled", [True, False], ids=["session-on", "session-off"])
async def test_iris_metadata_matches_jax(tmp_path, enabled, _process_defaults):
    async def body(f):
        _, doc = _same(await f.both("GET", "/iris/1/metadata"), "Content-Type")
        caps = json.loads(doc).get("capabilities")
        assert caps == ({"push": "/session/1/live", "annotations": "/annotations/1"}
                        if enabled else None)
        if not enabled:
            for method, path in SESSION_ROUTES:
                status, _ = _same(await f.both(method, path), "Allow")
                assert status == 405
    await _fronts(tmp_path, body, extra={"session": {"enabled": enabled}})


async def test_debug_requests_list_the_pushes(tmp_path, _process_defaults):
    """Each fan-out to a live channel is one ``/session/push`` record."""
    async def body(f):
        streams = [await f.http.get(url, headers=COOKIE) for url in f.urls("/session/1/live")]
        for r in streams:
            await _next_sse(r)
        _same(await f.both("POST", "/annotations/1", json={"shape": RECT}))
        for r in streams:
            await _next_sse(r)
            await _next_sse(r)
        (_, _, jb), (_, _, pb) = await f.both("GET", "/debug/requests")
        for doc in (json.loads(jb), json.loads(pb)):
            pushes = [e for e in doc["events"] if e["path"] == "/session/push"]
            assert sorted(e["tags"]["push.kind"] for e in pushes) == ["annotations",
                                                                      "invalidate"]
            assert all(e["method"] == "PUSH" and e["tags"]["push.channels"] == 1
                       for e in pushes)
        for r in streams:
            r.close()
    await _fronts(tmp_path, body, extra={"obs": {"head-sample-rate": 1.0}})


async def test_purge_from_another_thread_reaches_the_channel(tmp_path, _process_defaults):
    """The resolver's invalidation listener runs on its own thread: the
    delta still reaches the live channel, as in JAX."""
    async def body(f):
        streams = [await f.http.get(url, headers=COOKIE) for url in f.urls("/session/1/live")]
        for r in streams:
            await _next_sse(r)
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, f.jax_app._invalidate_image, 1)
        await loop.run_in_executor(None, f.port._invalidate_image, 1)
        got = [await _next_sse(r) for r in streams]
        assert got[1] == got[0] == (b'data: {"type":"invalidate","image":1,"tiles":[],'
                                    b'"epoch":null}\n\n')
        for r in streams:
            r.close()
    await _fronts(tmp_path, body)
