"""The port's HTTP front against the JAX package's aiohttp app, on the same
URLs: ETag values, ``Cache-Control``, ``X-Cache`` hit/miss, 304 on a
matching ``If-None-Match`` (strong, ``W/`` and comma lists; ``*`` not
honoured), a cache hit's session check, single-flight (N concurrent
identical misses, one pipeline execution), HEAD, OPTIONS and the 405 of
an unrouted path; ``/histogram`` bodies, headers, 304, HEAD and its 400,
403, 404 and 405 answers. The JAX app runs with ``cache.prefetch.enabled: false``
so that no predicted tile warms the cache. Also the cache pieces (ETag,
If-None-Match matching, key strings, the segmented LRU) against the JAX
package's. Tolerance: zero (statuses, header values and bodies)."""

import asyncio
import json
import threading
import time

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from omero_ms_pixel_buffer_tpu.auth.stores import MemorySessionStore
from omero_ms_pixel_buffer_tpu.cache import result_cache as jrc
from omero_ms_pixel_buffer_tpu.http.server import PixelBufferApp
from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu.io.pixels_service import (
    ImageRegistry as JaxRegistry,
    PixelsService as JaxService,
)
from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx
from omero_ms_pixel_buffer_tpu.utils.config import Config
from omero_ms_pixel_buffer_tpu_torch.cache import result_cache as prc
from omero_ms_pixel_buffer_tpu_torch.dispatch.batcher import BatchingTileWorker
from omero_ms_pixel_buffer_tpu_torch.http.server import TileServer
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import TilePipeline
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

IMG = np.random.default_rng(7).integers(0, 60000, (1, 1, 2, 256, 256), dtype=np.uint16)
COOKIE = {"Cookie": "sessionid=ck"}
TILE = "/tile/1/0/0/0?x=64&y=0&w=64&h=64&format=png"
# headers the two fronts must agree on, where present
COMPARED = ("Content-Type", "Content-Disposition", "ETag", "Cache-Control", "X-Cache",
            "Allow")


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("contract") / "img.ome.tiff")
    write_ome_tiff(path, IMG, tile_size=(64, 64))
    return path


class Fronts:
    """The JAX aiohttp app and the port's server over one image, each
    answering ``request(method, path, headers) -> (status, headers, body)``."""

    async def start(self, path):
        jreg = JaxRegistry()
        jreg.add(1, path)
        config = Config.from_dict({"session-store": {"type": "memory"},
                                   "cache": {"prefetch": {"enabled": False}}})
        self.jax_app = PixelBufferApp(config, pixels_service=JaxService(jreg),
                                      session_store=MemorySessionStore({"ck": "key1"}))
        self.jax = TestClient(TestServer(self.jax_app.make_app()),
                              loop=asyncio.get_running_loop())
        await self.jax.start_server()
        reg = ImageRegistry()
        reg.add(1, path)
        self.pipeline = TilePipeline(PixelsService(reg), buckets=(256, 512), device="cpu")
        self.port = TileServer(BatchingTileWorker(self.pipeline), sessions={"ck": "key1"})
        self.port_no = await self.port.start("127.0.0.1", 0)
        return self

    async def close(self):
        await self.jax.close()
        await self.port.close()
        self.pipeline.close()

    async def jax_request(self, method, path, headers=None):
        r = await self.jax.request(method, path, headers=headers or {})
        return r.status, {k: v for k, v in r.headers.items()}, await r.read()

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
        return int(lines[0].split()[1]), hdrs, body

    async def both(self, method, path, headers=None):
        """The same request to both fronts; asserts they answer alike and
        returns the port's answer."""
        js, jh, jb = await self.jax_request(method, path, headers)
        ps, ph, pb = await self.port_request(method, path, headers)
        jh = {k.lower(): v for k, v in jh.items()}
        ph_l = {k.lower(): v for k, v in ph.items()}
        assert ps == js, (method, path, headers, ps, js)
        assert pb == jb, (method, path, headers)
        for name in COMPARED:
            assert ph_l.get(name.lower()) == jh.get(name.lower()), (name, method, path, headers)
        if method == "HEAD" or ps != 304:
            assert ph_l.get("content-length") == jh.get("content-length"), (method, path)
        return ps, ph_l, pb


async def _with_fronts(image_path, body):
    f = await Fronts().start(image_path)
    try:
        await body(f)
    finally:
        await f.close()


@pytest.mark.parametrize("urls", [
    [TILE, TILE],
    ["/tile/1/0/0/0?w=0&h=0&format=png", "/tile/1/0/0/0?x=0&y=0&w=256&h=256&format=png"],
    ["/tile/1/1/0/0?x=0&y=0&w=100&h=30"] * 2,
    ["/tile/1/0/0/0?x=5&y=7&w=40&h=33&format=tif"] * 2,
    ["/tile/1/0/0/0?x=200&y=0&w=100&h=64&format=png", "/tile/9/0/0/0?format=png",
     "/tile/1/0/zz/0?format=png"],
], ids=["png_miss_hit", "full_plane_spellings", "raw", "tif", "failures"])
async def test_tiles_and_cache_headers_match_jax(image_path, urls):
    """Miss then hit: the same bodies, ETags, Cache-Control and X-Cache;
    the w = h = 0 spelling shares the explicit full plane's entry; 404
    and 400 answers carry none of them."""
    async def body(f):
        seen = []
        for url in urls:
            status, hdrs, _ = await f.both("GET", url, COOKIE)
            seen.append((status, hdrs.get("x-cache")))
        if urls[0] == urls[1] or "w=0" in urls[0]:
            assert seen[:2] == [(200, "miss"), (200, "hit")]
    await _with_fronts(image_path, body)


@pytest.mark.parametrize("cold", [False, True], ids=["on_a_hit", "on_a_fresh_render"])
async def test_conditional_get_matches_jax(image_path, cold):
    """A matching If-None-Match answers 304 (strong, W/, in a list), on a
    cache hit and on a fresh render; ``*`` and a stale validator get the
    body."""
    async def body(f):
        etag = prc.make_etag((await f.port_request("GET", TILE, COOKIE))[2])
        if cold:  # a fresh server pair: the validator meets a cold cache
            await f.close()
            await f.start(image_path)
        for inm, want in ((etag, 304), ("W/" + etag, 304), ('"stale", ' + etag, 304),
                          ("*", 200), ('"stale"', 200)):
            status, hdrs, got = await f.both("GET", TILE, {**COOKIE, "If-None-Match": inm})
            assert status == want, inm
            assert hdrs["etag"] == etag
            if status == 304:
                assert got == b"" and "content-length" not in hdrs
    await _with_fronts(image_path, body)


async def test_cache_hit_still_needs_a_session(image_path):
    async def body(f):
        etag = (await f.both("GET", TILE, COOKIE))[1]["etag"]
        for headers in ({}, {"Cookie": "sessionid=bad"},
                        {"Cookie": "sessionid=bad", "If-None-Match": etag}):
            status, _, got = await f.both("GET", TILE, headers)
            assert (status, got) == (403, b"Permission denied")
    await _with_fronts(image_path, body)


async def test_verbs_match_jax(image_path):
    """HEAD answers the GET's headers without a body (miss, then hit);
    OPTIONS answers the discovery JSON on any path without a session; an
    unrouted path and a wrong method answer 405 (403 first without a
    session)."""
    async def body(f):
        status, hdrs, got = await f.both("HEAD", TILE, COOKIE)
        assert (status, got, hdrs["x-cache"]) == (200, b"", "miss")
        assert int(hdrs["content-length"]) > 0
        assert (await f.both("HEAD", TILE, COOKIE))[1]["x-cache"] == "hit"
        for path in ("/anything/at/all", TILE):
            status, hdrs, got = await f.both("OPTIONS", path)
            assert status == 200 and b'"provider": "PixelBufferMicroservice"' in got
        for method, path, headers, want in (
                ("GET", "/tile/1/0/0", COOKIE, 405), ("GET", "/tile/1/0/0", {}, 403),
                ("POST", TILE, COOKIE, 405), ("PUT", "/nope", COOKIE, 405),
                ("HEAD", "/nope", COOKIE, 405), ("DELETE", "/healthz", {}, 405)):
            status, _, got = await f.both(method, path, headers)
            assert status == want, (method, path)
            if want == 405 and method != "HEAD":
                assert got == b"405: Method Not Allowed"
        status, hdrs, got = await f.port_request("HEAD", "/healthz")
        assert (status, got) == (200, b"") and int(hdrs["Content-Length"]) > 0
    await _with_fronts(image_path, body)


@pytest.mark.parametrize("url", ["/tile/9/0/0/0?format=png", "/tile/1/7/0/0?format=png",
                                 "/tile/1/0/0/0?format=PNG"],
                         ids=["unknown_image", "z_out_of_range", "format_PNG"])
async def test_head_of_an_empty_error_matches_jax(image_path, url):
    """HEAD of a 404 without a body carries no Content-Length, as the JAX
    aiohttp app answers; the GET of it keeps ``Content-Length: 0``."""
    async def body(f):
        status, hdrs, got = await f.both("HEAD", url, COOKIE)
        assert (status, got) == (404, b"") and "content-length" not in {
            k.lower() for k in hdrs}
        status, hdrs, _ = await f.both("GET", url, COOKIE)
        assert (status, hdrs["content-length"]) == (404, "0")
    await _with_fronts(image_path, body)


@pytest.mark.parametrize("front", ["port", "jax"])
async def test_concurrent_identical_misses_run_once(image_path, front):
    """Six concurrent identical misses share one pipeline execution (one
    flight) in both fronts, and all six answer the same ETag."""
    async def body(f):
        if front == "port":
            pipeline, request = f.pipeline, f.port_request
        else:
            pipeline, request = f.jax_app.pipeline, f.jax_request
        calls = []
        lock = threading.Lock()
        handle = pipeline.handle

        def slow_handle(ctx):
            with lock:
                calls.append(ctx)
            time.sleep(0.2)  # hold the flight open for the joiners
            return handle(ctx)

        pipeline.handle = slow_handle
        out = await asyncio.gather(*(request("GET", TILE, COOKIE) for _ in range(6)))
        assert [s for s, _, _ in out] == [200] * 6
        etags = {{k.lower(): v for k, v in h.items()}["etag"] for _, h, _ in out}
        assert len(etags) == 1 and len(calls) == 1
    await _with_fronts(image_path, body)


# -- /histogram ----------------------------------------------------------------

HIST_URLS = [  # the image has one channel and two z planes
    "/histogram/1/0/0/0?w=64&h=64",
    "/histogram/1/1/0/0?x=10&y=20&w=100&h=50&bins=2",
    "/histogram/1/0/0/0?c=1|100:40000&bins=65536",
    "/histogram/1/0/0/0?c=1,-2&usePixelsTypeRange=true&bins=17&w=0&h=0",
    "/histogram/1/1/0/0?c=1|0:30000&x=200&y=3&w=56&h=250",
]
HIST_ERRORS = [
    ("/histogram/1/0/0/0?bins=1", 400), ("/histogram/1/0/0/0?bins=abc", 400),
    ("/histogram/1/0/0/0?bins=65537", 400), ("/histogram/1/0/0/0?c=", 400),
    ("/histogram/1/0/0/0?c=1,1", 400), ("/histogram/1/0/0/0?c=zz", 400),
    ("/histogram/1/0/0/0?c=-1", 400), ("/histogram/1/0/0/0?x=abc", 400),
    ("/histogram/1/zz/0/0", 400), ("/histogram/1/0/0/0?c=2", 404),
    ("/histogram/1/0/5/0", 404), ("/histogram/1/7/0/0", 404), ("/histogram/9/0/0/0", 404),
    ("/histogram/1/0/0/0?x=300&w=10&h=10", 404),
]


@pytest.mark.parametrize("url", HIST_URLS, ids=range(len(HIST_URLS)))
async def test_histogram_front_matches_jax(image_path, url):
    """Miss then hit: equal JSON bodies, Content-Type, ETags,
    Cache-Control and X-Cache; a matching If-None-Match answers 304; HEAD
    answers the GET's headers."""
    async def body(f):
        status, hdrs, got = await f.both("GET", url, COOKIE)
        assert (status, hdrs["x-cache"], hdrs["content-type"]) == (
            200, "miss", "application/json")
        assert got.startswith(b'{"imageId":1,')
        assert (await f.both("GET", url, COOKIE))[1]["x-cache"] == "hit"
        status, _, got = await f.both("GET", url, {**COOKIE, "If-None-Match": hdrs["etag"]})
        assert (status, got) == (304, b"")
        status, head, got = await f.both("HEAD", url, COOKIE)
        assert (status, got, head["etag"]) == (200, b"", hdrs["etag"])
    await _with_fronts(image_path, body)


async def test_histogram_errors_match_jax(image_path):
    """400s (bins, c, region and path parameters), 404s (channel, plane,
    image and region out of range), 403 without a session and 405 for
    another method."""
    async def body(f):
        for url, want in HIST_ERRORS:
            status, _, _ = await f.both("GET", url, COOKIE)
            assert status == want, url
        for headers in ({}, {"Cookie": "sessionid=bad"}):
            assert (await f.both("GET", HIST_URLS[0], headers))[0] == 403
        status, hdrs, got = await f.both("POST", HIST_URLS[0], COOKIE)
        assert (status, got, hdrs["allow"]) == (405, b"405: Method Not Allowed",
                                                "GET,HEAD,OPTIONS")
        health = f.port.health()
        assert health["analysis"]["enabled"]
    await _with_fronts(image_path, body)


# -- the cache pieces against the JAX package's ------------------------------


def test_etag_and_matching_match_jax():
    bodies = [b"", b"x", bytes(range(256)) * 9]
    for b in bodies:
        assert prc.make_etag(b) == jrc.make_etag(b)
    etag = prc.make_etag(b"tile")
    for inm in ("", etag, "W/" + etag, f'"a", {etag}', f'"a",W/{etag} ', "*", '"a"',
                etag[1:-1], f"{etag}x"):
        assert prc.etag_matches(inm, etag) == jrc.etag_matches(inm, etag), inm


@pytest.mark.parametrize("fields", [
    (1, 0, 0, 0, (0, 0, 64, 64), None, "png", "k"),
    (7, 2, 1, 3, (5, 9, 0, 0), 2, None, "sess"),
    (3, 0, 0, 0, (0, 0, 512, 512), 0, "tif", None),
])
def test_cache_keys_match_jax(fields):
    image, z, c, t, region, res, fmt, sess = fields
    p = TileCtx(image, z, c, t, RegionDef(*region), resolution=res, format=fmt,
                omero_session_key=sess)
    j = JaxCtx(image, z, c, t, JaxRegion(*region), resolution=res, format=fmt,
               omero_session_key=sess)
    for q in ("", "up.6.fast"):
        assert p.cache_key(q) == j.cache_key(q)
        assert p.dedupe_key(q) == j.dedupe_key(q)


def test_encode_signature_matches_jax(image_path):
    jreg = JaxRegistry()
    jreg.add(1, image_path)
    from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline as JaxPipeline

    jp = JaxPipeline(JaxService(jreg), engine="host")
    port = TilePipeline(PixelsService(ImageRegistry()), device="cpu")
    try:
        assert port.encode_signature() == jp.encode_signature() == "up.6.fast"
    finally:
        jp.close()
        port.close()


def test_segmented_lru_matches_jax():
    """A random sequence of gets and puts under a small byte budget: the
    same hits, misses, evictions and segment sizes as the JAX package's
    SLRU without an admission gate."""
    rng = np.random.default_rng(3)
    p, j = prc.SegmentedLRU(4000, 0.5), jrc.SegmentedLRU(4000, 0.5)
    for _ in range(2000):
        key = f"k{int(rng.integers(0, 40))}"
        if rng.random() < 0.5:
            body = bytes(int(rng.integers(1, 700)))
            ev_p = [k for k, _ in p.put(key, prc.CachedTile(body))]
            ev_j = [k for k, _ in j.put(key, jrc.CachedTile(body))]
            assert ev_p == ev_j
        else:
            gp, gj = p.get(key), j.get(key)
            assert (gp is None) == (gj is None)
            if gp is not None:
                assert gp.etag == gj.etag
    snap_p, snap_j = p.snapshot(), j.snapshot()
    assert snap_p == snap_j and snap_p["hits"] > 0 and snap_p["misses"] > 0


async def test_result_cache_admission_bounds():
    cache = prc.TileResultCache(memory_bytes=1 << 20, max_entry_bytes=1000)
    cache.put("small", prc.CachedTile(b"x" * 1000))
    cache.put("large", prc.CachedTile(b"x" * 1001))
    assert await cache.get("small") is not None and await cache.get("large") is None
    assert cache.snapshot()["memory"]["entries"] == 1


# -- the request line, escapes and repeated headers, byte for byte ----------------------
#
# Each case is one raw request, sent as the same bytes to both fronts over a
# socket; the answers' status lines, headers (aiohttp's Date and Server
# aside) and bodies must be equal, the interim ``100 Continue`` included.


async def _raw(port, data: bytes, body: bytes = b"") -> bytes:
    """Everything the server writes back to ``data`` (then ``body``, once
    the head is out) on one connection that the server closes."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(data)
        await writer.drain()
        if body:
            await asyncio.sleep(0.05)
            writer.write(body)
            await writer.drain()
        return await asyncio.wait_for(reader.read(), 30)
    finally:
        writer.close()


def _answers(raw: bytes):
    """[(status line, headers less Date and Server, body)] of every answer
    in ``raw`` (an interim 100 first)."""
    out = []
    while raw:
        top, _, rest = raw.partition(b"\r\n\r\n")
        lines = top.decode("latin-1").split("\r\n")
        headers = {}
        for line in lines[1:]:
            name, _, value = line.partition(": ")
            if name.lower() not in ("date", "server"):
                headers[name.lower()] = value
        n = int(headers.get("content-length", 0)) if " 100 " not in lines[0] + " " else 0
        out.append((lines[0], headers, rest[:n]))
        raw = rest[n:]
    return out


def _request(method, target, *headers, version=" HTTP/1.1", connection="close"):
    head = f"{method} {target}{version}\r\nHost: x\r\nConnection: {connection}\r\n"
    return (head + "".join(h + "\r\n" for h in headers) + "\r\n").encode("latin-1")


CK = "Cookie: sessionid=ck"
WIRE_CASES = {
    # percent-escapes in the path: the route matches the path with %2F and
    # %25 kept, and each group then decodes
    "escaped_image_id": (_request("GET", "/tile/%31/0/0/0?w=64&h=64", CK), 200),
    "escaped_plus": (_request("GET", "/tile/%2B1/0/0/0?w=64&h=64", CK), 200),
    "escaped_space": (_request("GET", "/tile/1/0/1/%201", CK), 404),
    "escaped_slash_in_a_group": (_request("GET", "/tile/1%2F0/0/0/0", CK), 400),
    "lower_case_escaped_slash": (_request("GET", "/tile/%31%2f/0/0/0", CK), 400),
    "escaped_healthz": (_request("GET", "/heal%74hz/x"), 403),
    # escapes that are not UTF-8 stay as written
    "non_utf8_query_escape": (_request("GET", "/tile/1/1/1/0?x=%FF", CK), 400),
    "non_utf8_query_escape_lower": (_request("GET", "/tile/1/0/0/0?x=%e9", CK), 400),
    "truncated_utf8_escape": (_request("GET", "/tile/1/0/0/0?x=%C3", CK), 400),
    "raw_utf8_in_the_query": (
        b"GET /tile/1/0/0/0?x=\xc3\xa9 HTTP/1.1\r\nHost: x\r\n" + CK.encode() + b"\r\n\r\n",
        400),
    "raw_utf8_in_the_path": (
        b"GET /tile/\xc3\xa9/0/0/0 HTTP/1.1\r\nHost: x\r\n\r\n", 400),
    # repeated headers: the first value counts
    "two_cookies_first_refused": (
        _request("GET", "/tile/1/0/0/0?w=64&h=64", "Cookie: a=b", CK), 403),
    "two_cookies_first_served": (
        _request("GET", "/tile/1/0/0/0?w=64&h=64", CK, "Cookie: a=b"), 200),
    "two_content_lengths": (
        _request("GET", "/tile/1/0/0/0", CK, "Content-Length: 0", "Content-Length: 0"), 400),
    # request-line edges
    "lower_case_method": (_request("get", "/tile/1/0/0/0", CK), 400),
    "unknown_version": (_request("GET", "/healthz", version=" HTTP/1.2"), 400),
    "not_http": (_request("GET", "/healthz", version=" FOO/1.1"), 400),
    "http_1_0": (_request("GET", TILE, CK, version=" HTTP/1.0"), 200),
    "http_1_0_keep_alive": (_request("GET", TILE, CK, version=" HTTP/1.0",
                                     connection="keep-alive"), 200),
    "http_0_9": (_request("GET", TILE, CK, version=""), 200),
    "two_spaces": (_request("GET ", TILE, CK), 200),
    "method_walks_off_the_table": (_request("FOO", "/healthz"), 400),
    "no_space_after_method": (_request("GETX", "/healthz"), 400),
    "raw_byte_in_the_fragment": (b"GET /x#\xc3 HTTP/1.1\r\nHost: x\r\n\r\n", 400),
    "tab_in_the_query": (b"GET /a?b\tc HTTP/1.1\r\nHost: x\r\n\r\n", 400),
    "unexpected_start_of_target": (b"GET \xc3 HTTP/1.1\r\nHost: x\r\n\r\n", 400),
    "two_digit_major_version": (_request("GET", "/healthz", version=" HTTP/11.1"), 400),
    "junk_after_version": (_request("GET", "/healthz", version=" HTTP/1.1x"), 400),
    "explicit_http_0_9": (_request("GET", TILE, CK, version=" HTTP/0.9"), 200),
    "empty_lines_first": (b"\r\n\r\n" + _request("GET", TILE, CK), 200),
    "expect_continue": (_request("GET", TILE, CK, "Expect: 100-continue"), 200),
    "expect_unknown": (_request("GET", TILE, CK, "Expect: teapot", "Content-Length: 2"), 417),
}


@pytest.mark.parametrize("case", list(WIRE_CASES))
async def test_wire_edges_match_jax(image_path, case):
    """The parsing faults the reference probe found, pinned: equal status
    lines, headers and bodies for the same raw bytes."""
    data, status = WIRE_CASES[case]

    async def body(f):
        if "keep_alive" in case:
            # aiohttp keeps the HTTP/1.0 connection: read one answer's worth
            answers = []
            for port in (f.jax.server.port, f.port_no):
                reader, writer = await asyncio.open_connection("127.0.0.1", port)
                writer.write(data)
                head = await reader.readuntil(b"\r\n\r\n")
                n = int(head.lower().split(b"content-length: ")[1].split(b"\r\n")[0])
                answers.append(_answers(head + await reader.readexactly(n)))
                writer.close()
        else:
            answers = [_answers(await _raw(port, data))
                       for port in (f.jax.server.port, f.port_no)]
        assert answers[1] == answers[0]
        assert answers[1][-1][0].split()[1] == str(status)
    await _with_fronts(image_path, body)


async def test_expect_continue_answers_before_the_body(image_path):
    """``Expect: 100-continue`` on a request with a body: both fronts send
    ``100 Continue`` before the client sends the body, then the answer."""
    head = _request("POST", "/tile/1/0/0/0", CK, "Expect: 100-continue", "Content-Length: 4")

    async def body(f):
        seen = []
        for port in (f.jax.server.port, f.port_no):
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(head)
            interim = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 10)
            writer.write(b"abcd")
            rest = await asyncio.wait_for(reader.read(), 10)
            writer.close()
            seen.append(_answers(interim + rest))
        assert seen[1] == seen[0]
        assert seen[1][0][0] == "HTTP/1.1 100 Continue" and seen[1][1][0].split()[1] == "405"
    await _with_fronts(image_path, body)


@pytest.mark.parametrize("first,second,status", [
    ("match", '"nope"', 304), ('"nope"', "match", 200)], ids=["first-matches", "second-matches"])
async def test_repeated_if_none_match_reads_the_first(image_path, first, second, status):
    async def body(f):
        _, hdrs, _ = await f.both("GET", TILE, COOKIE)
        etag = hdrs["etag"]
        data = _request("GET", TILE, CK, f"If-None-Match: {etag if first == 'match' else first}",
                        f"If-None-Match: {etag if second == 'match' else second}")
        answers = [_answers(await _raw(port, data)) for port in (f.jax.server.port, f.port_no)]
        assert answers[1] == answers[0]
        assert answers[1][0][0].split()[1] == str(status)
    await _with_fronts(image_path, body)


@pytest.mark.parametrize("kind", ["path", "path_safe", "query"])
def test_unquote_matches_yarl(kind):
    """The port's percent-decoding (``http/target.py``) against yarl's, the
    decoder behind aiohttp's ``request.path``, its router and its query,
    on seeded random mixes of escapes (UTF-8 runs, truncated and invalid
    ones, ``%2F``, ``%25``, ``+``)."""
    import random

    from yarl._quoting import _Unquoter

    from omero_ms_pixel_buffer_tpu_torch.http import target

    yarl_fn, port_fn = {
        "path": (_Unquoter(unsafe="+"), target.path_of),
        "path_safe": (_Unquoter(ignore="/%", unsafe="+"), target.path_safe),
        "query": (_Unquoter(plus=True), lambda v: target.unquote(v, plus=True)),
    }[kind]
    parts = ["%", "2F", "2f", "25", "C3", "A9", "E2", "82", "AC", "FF", "e9", "+", "/", "a",
             "%2", "%z", "F0", "9F", "98", "00", "3F", "%%", "é"]
    rng = random.Random(16)
    for _ in range(20000):
        value = "".join(rng.choice(parts) for _ in range(rng.randint(0, 10)))
        assert port_fn(value) == yarl_fn(value), value


# -- request bodies with the ingest plane on ---------------------------------


def _tree_digest(root):
    import hashlib
    import os

    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


async def test_chunked_ingest_put_is_read_as_jax_reads_it(tmp_path, monkeypatch):
    """A chunked ``PUT`` (three chunks): both fronts decode it, commit the
    same objects (one clock in the gzip headers) and read the tile back."""
    import gzip

    from test_torch_ingest import AUTH, Fronts, _FixedClock, _raw, _wire

    monkeypatch.setattr(gzip, "time", _FixedClock)
    f = await Fronts().start(tmp_path)
    try:
        tile = np.random.default_rng(31).integers(0, 4096, (32, 32), dtype=np.uint16)
        body = _wire(tile)
        status, hdrs, out = await f.both("PUT", "/image/1/tile/0/0/0?x=32&y=32&w=32&h=32", AUTH,
                                         chunks=[body[:100], body[100:1500], body[1500:]])
        assert status == 200 and hdrs["content-type"].startswith("application/json")
        status, _, back = await _raw(f.port_no, "GET", "/tile/1/0/0/0?x=32&y=32&w=32&h=32",
                                     AUTH)
        assert status == 200 and back == body
        assert _tree_digest(f.roots["jax"]) == _tree_digest(f.roots["port"])
    finally:
        await f.close()


async def test_96_mib_planes_post_commits_in_both(tmp_path):
    """Three 4096² uint16 planes in one ``POST .../planes``: a 96 MiB body,
    under the default bound (``staging-bytes`` 256 MiB + 64 KiB). Both
    fronts read it whole and commit the same objects."""
    from omero_ms_pixel_buffer_tpu.io.zarr import write_ngff
    from test_torch_ingest import AUTH, Fronts

    src = str(tmp_path / "src.zarr")
    write_ngff(src, np.zeros((1, 3, 1, 4096, 4096), np.uint16), chunks=(2048, 2048), levels=1,
               zarr_format=2, compressor=None)
    f = await Fronts().start(tmp_path, src=src)
    try:
        planes = np.random.default_rng(96).integers(0, 65535, (3, 4096, 4096), dtype=np.uint16)
        body = planes.astype(">u2").tobytes()
        assert len(body) == 96 << 20
        status, _, out = await f.both("POST", "/image/1/planes?planes=0:0:0,0:1:0,0:2:0", AUTH,
                                      body)
        assert status == 200
        assert json.loads(out)["bytes"] == 96 << 20
        assert _tree_digest(f.roots["jax"]) == _tree_digest(f.roots["port"])
    finally:
        await f.close()


@pytest.mark.parametrize("entry_kb,size,chunked", [
    (4096, (8 << 20) + 65536, False), (4096, 9 << 20, False), (4096, 9 << 20, True),
    (4096, (8 << 20) + 65535, False), (16384, (16 << 20) + 65536, False),
    (16384, (16 << 20) + 65535, False),
], ids=["at-the-bound", "over", "over-chunked", "under", "entry-bound", "under-entry-bound"])
async def test_ingest_body_bound_answers_like_aiohttp(tmp_path, entry_kb, size, chunked):
    """With the ingest plane the bound is aiohttp's ``client_max_size`` of
    the JAX app: the larger of ``staging-bytes`` (8 MiB here) + 64 KiB and
    ``cache.max-entry-kb`` + 64 KiB. A body at or over it is
    aiohttp's 413 from ``request.read()`` (its text up to the size it
    names, which follows the socket's reads in aiohttp); one byte under
    it reaches the handler (a tile body of the wrong size: 400). Nothing
    is written."""
    from test_torch_ingest import AUTH, Fronts

    bound = max(8 << 20, entry_kb << 10) + 65536
    f = await Fronts().start(tmp_path, extra={
        "ingest": {"enabled": True, "staging-bytes": 8 << 20},
        "cache": {"prefetch": {"enabled": False}, "max-entry-kb": entry_kb}})
    try:
        body = b"\0" * size
        status, _, out = await f.both(
            "PUT", "/image/1/tile/0/0/0?x=0&y=0&w=32&h=32", AUTH, body,
            chunks=[body[i:i + (1 << 20)] for i in range(0, size, 1 << 20)] if chunked else None,
            compare_body=False)
        if size >= bound:
            prefix = f"Maximum request body size {bound} exceeded, actual body size "
            assert status == 413 and out.decode().startswith(prefix)
        else:
            assert status == 400 and out.startswith(b"tile body is")
        assert _tree_digest(f.roots["jax"]) == _tree_digest(f.roots["port"])
    finally:
        await f.close()
