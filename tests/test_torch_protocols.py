"""The port's DZI, IIIF and Iris adapters (``http/protocols/``) against the
JAX package's, on the CPU.

- The grammar functions (``max_level``, ``descriptor_xml``, ``_dyadic``,
  ``resolve_tile``, ``parse_region``, ``map_region_to_level``,
  ``parse_size``, ``parse_rotation``, ``parse_quality_format``,
  ``info_document``, ``layer_grid``, ``metadata_document``) return the
  same values, or raise the same class with the same message, on seeded
  random and edge inputs.
- Both fronts answer one URL list (descriptors, info and metadata
  documents, tiles of every dialect, 400, 404, 501, 503 with
  ``Retry-After`` for an open breaker, 403, 405) with equal statuses,
  headers and bodies, by GET and by HEAD (HEAD of an empty answer carries
  no ``Content-Length``), and a matching ``If-None-Match`` answers 304.
- An adapter tile equals its native ``/render`` request in bytes and
  ETag, and the native request after it is a cache hit (and the other way
  round).

The JAX app runs with ``cache.prefetch.enabled: false`` and both fronts
with the session plane off (Iris ``capabilities`` with the plane on are
pinned by ``tests/test_torch_session_plane.py``). Tolerance: zero."""

import asyncio

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from omero_ms_pixel_buffer_tpu.auth.stores import MemorySessionStore
from omero_ms_pixel_buffer_tpu.errors import TileError as JaxTileError
from omero_ms_pixel_buffer_tpu.http.protocols import dzi as jdzi
from omero_ms_pixel_buffer_tpu.http.protocols import iiif as jiiif
from omero_ms_pixel_buffer_tpu.http.protocols import iris as jiris
from omero_ms_pixel_buffer_tpu.http.server import PixelBufferApp
from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu.io.pixels_service import (
    ImageRegistry as JaxRegistry,
    PixelsService as JaxService,
)
from omero_ms_pixel_buffer_tpu.io.stores import StoreUnavailableError as JaxUnavailable
from omero_ms_pixel_buffer_tpu.utils.config import Config
from omero_ms_pixel_buffer_tpu_torch.dispatch.batcher import BatchingTileWorker
from omero_ms_pixel_buffer_tpu_torch.errors import TileError
from omero_ms_pixel_buffer_tpu_torch.http.protocols import dzi as pdzi
from omero_ms_pixel_buffer_tpu_torch.http.protocols import iiif as piiif
from omero_ms_pixel_buffer_tpu_torch.http.protocols import iris as piris
from omero_ms_pixel_buffer_tpu_torch.http.server import TileServer
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.io.stores import StoreUnavailableError
from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import TilePipeline
from omero_ms_pixel_buffer_tpu_torch.utils.config import Config as PortConfig

# T, C, Z, Y, X: 600x520 with levels 300x260 and 150x130 -> DZI max level
# 10, levels 10-8 backed
IMG = np.random.default_rng(31).integers(0, 60000, (1, 2, 2, 520, 600), dtype=np.uint16)
COOKIE = {"Cookie": "sessionid=ck", "Host": "viewer.example"}
BROKEN = 7  # an image whose store's breaker is open
COMPARED = ("content-type", "content-disposition", "etag", "cache-control", "x-cache",
            "allow", "retry-after", "x-ompb-degraded", "content-length")


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("protocols") / "img.ome.tiff")
    write_ome_tiff(path, IMG, tile_size=(128, 128), pyramid_levels=3)
    return path


def _open_breaker(service, unavailable):
    """``get_pixel_buffer`` of image ``BROKEN`` raises as a store behind
    an open breaker does (retry after 2.5 s)."""
    inner = service.get_pixel_buffer

    def get(image_id, *args, **kwargs):
        if int(image_id) == BROKEN:
            raise unavailable("store:test breaker open", 2.5)
        return inner(image_id, *args, **kwargs)

    service.get_pixel_buffer = get


class Fronts:
    """The JAX aiohttp app and the port's server over one image, each
    answering ``request(method, path, headers) -> (status, headers, body)``
    with lower-case header names. ``config`` extends the JAX config;
    ``port_kwargs`` go to the port's ``TileServer``."""

    def __init__(self, config=None, port_kwargs=None, buckets=(256, 512)):
        self.config = config or {}
        self.port_kwargs = port_kwargs or {}
        self.buckets = buckets

    async def start(self, path):
        jreg = JaxRegistry()
        jreg.add(1, path)
        jreg.add(BROKEN, path)
        raw = {"session-store": {"type": "memory"}, "session": {"enabled": False},
               "cache": {"prefetch": {"enabled": False}}}
        raw.update(self.config)
        jservice = JaxService(jreg)
        _open_breaker(jservice, JaxUnavailable)
        self.jax_app = PixelBufferApp(Config.from_dict(raw), pixels_service=jservice,
                                      session_store=MemorySessionStore({"ck": "key1"}))
        self.jax = TestClient(TestServer(self.jax_app.make_app()),
                              loop=asyncio.get_running_loop())
        await self.jax.start_server()
        reg = ImageRegistry()
        reg.add(1, path)
        reg.add(BROKEN, path)
        service = PixelsService(reg)
        _open_breaker(service, StoreUnavailableError)
        self.pipeline = TilePipeline(service, buckets=self.buckets, device="cpu")
        self.port = TileServer(BatchingTileWorker(self.pipeline), sessions={"ck": "key1"},
                               config=PortConfig.from_dict({"session-store": {"type": "memory"},
                                                            "session": {"enabled": False}}),
                               **self.port_kwargs)
        self.port_no = await self.port.start("127.0.0.1", 0)
        return self

    async def close(self):
        await self.jax.close()
        await self.port.close()
        self.pipeline.close()

    async def jax_request(self, method, path, headers=None):
        r = await self.jax.request(method, path, headers=headers or {})
        return r.status, {k.lower(): v for k, v in r.headers.items()}, await r.read()

    async def port_request(self, method, path, headers=None):
        reader, writer = await asyncio.open_connection("127.0.0.1", self.port_no)
        try:
            head = f"{method} {path} HTTP/1.1\r\nConnection: close\r\n"
            headers = {"Host": "x", **(headers or {})}
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

    async def both(self, method, path, headers=None):
        """The same request to both fronts; asserts equal statuses,
        bodies and compared headers and returns the port's answer."""
        js, jh, jb = await self.jax_request(method, path, headers)
        ps, ph, pb = await self.port_request(method, path, headers)
        assert (ps, pb) == (js, jb), (method, path, ps, js, pb[:80], jb[:80])
        for name in COMPARED:
            assert ph.get(name) == jh.get(name), (name, method, path, ph.get(name),
                                                  jh.get(name))
        return ps, ph, pb


async def with_fronts(path, body, **kwargs):
    f = await Fronts(**kwargs).start(path)
    try:
        await body(f)
    finally:
        await f.close()


# -- the grammar functions ----------------------------------------------------------


def _same(port_fn, jax_fn, *args):
    """Equal values, or the same error class name and message."""
    try:
        want = ("ok", jax_fn(*args))
    except JaxTileError as e:
        want = (type(e).__name__, e.code, e.message)
    try:
        got = ("ok", port_fn(*args))
    except TileError as e:
        got = (type(e).__name__, e.code, e.message)
    assert got == want, args
    return got


def _pyramid(rng):
    """Random level sizes: floor or ceil halvings, odd and non-power-of-two
    extents, sometimes a non-dyadic (factor 3) level."""
    w, h = (int(v) for v in rng.integers(1, 5000, 2))
    sizes = [(w, h)]
    for _ in range(int(rng.integers(0, 5))):
        if rng.random() < 0.15:
            w, h = max(1, w // 3), max(1, h // 3)
        elif rng.random() < 0.5:
            w, h = max(1, w // 2), max(1, h // 2)
        else:
            w, h = max(1, (w + 1) // 2), max(1, (h + 1) // 2)
        sizes.append((w, h))
    return sizes


@pytest.mark.parametrize("seed", range(6))
def test_dzi_grammar_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        sizes = _pyramid(rng)
        w0, h0 = sizes[0]
        assert pdzi.max_level(w0, h0) == jdzi.max_level(w0, h0)
        tile = int(rng.choice([1, 64, 254, 256, 512]))
        assert pdzi.descriptor_xml(w0, h0, tile) == jdzi.descriptor_xml(w0, h0, tile)
        assert pdzi.descriptor_xml(w0, h0, tile, "jpeg") == jdzi.descriptor_xml(
            w0, h0, tile, "jpeg")
        res = int(rng.integers(0, 6))
        actual = int(rng.integers(1, w0 + 2))
        assert pdzi._dyadic(w0, res, actual) == jdzi._dyadic(w0, res, actual)
        top = pdzi.max_level(w0, h0)
        for level in (top + 1, top, top - 1, int(rng.integers(0, top + 2))):
            col, row = (int(v) for v in rng.integers(0, 30, 2))
            _same(pdzi.resolve_tile, jdzi.resolve_tile, sizes, level, col, row, tile)


def test_dzi_edges_match_jax():
    for sizes in ([(1, 1)], [(1, 1), (1, 1)], [(256, 256), (128, 128)], [(257, 3), (129, 2)],
                  [(600, 520), (300, 260), (150, 130)], [(8192, 8192), (2048, 2048)]):
        w0, h0 = sizes[0]
        for level in range(0, pdzi.max_level(w0, h0) + 2):
            for col, row in ((0, 0), (1, 0), (0, 1), (2, 2), (40, 0)):
                _same(pdzi.resolve_tile, jdzi.resolve_tile, sizes, level, col, row, 256)
    assert pdzi.descriptor_xml(8192, 8192, 256) == jdzi.descriptor_xml(8192, 8192, 256)


REGIONS = ["full", "square", "pct:1,2,3,4", "0,0,10,10", "1,2,3", "a,b,c,d", "-1,0,5,5",
           "0,0,0,5", "599,519,50,50", "600,0,5,5", "0,520,5,5", "10,20,1000,1000", "",
           "5,5,5,5,5", "0,0,600,520"]
SIZES = ["max", "full", "^max", "pct:50", "!", ",", "256,", ",130", "150,130", "!200,200",
         "!100,100", "!1,1", "!150,", "0,10", "10,-1", "x,5", "300,260", "600,", "123,",
         "!10000,10000", "1,2,3"]
ROTATIONS = ["0", "360", "90", "!0", "180.5", ""]
QUALITIES = ["default.png", "color.jpg", "gray.png", "grey.jpg", "bitonal.png", "default.gif",
             "default", "weird.png", "default.tif", ".png", "default.PNG"]


def test_iiif_grammar_matches_jax():
    sizes = [(600, 520), (300, 260), (150, 130)]
    for region in REGIONS:
        got = _same(piiif.parse_region, jiiif.parse_region, region, 600, 520)
        if got[0] != "ok":
            continue
        x, y, w, h = got[1]
        cands = [(res, piiif.map_region_to_level(x, y, w, h, sizes, res))
                 for res in range(len(sizes))]
        assert cands == [(res, jiiif.map_region_to_level(x, y, w, h, sizes, res))
                         for res in range(len(sizes))]
        for size in SIZES:
            _same(piiif.parse_size, jiiif.parse_size, size, cands)
    for rotation in ROTATIONS:
        _same(piiif.parse_rotation, jiiif.parse_rotation, rotation)
    for last in QUALITIES:
        _same(piiif.parse_quality_format, jiiif.parse_quality_format, last)


@pytest.mark.parametrize("seed", range(4))
def test_iiif_and_iris_documents_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(100):
        sizes = _pyramid(rng)
        tile = int(rng.choice([64, 256, 300]))
        for version in (2, 3):
            assert piiif.info_document("http://h/iiif/1", sizes, tile, version) == \
                jiiif.info_document("http://h/iiif/1", sizes, tile, version)
        x, y = (int(v) for v in rng.integers(0, 50, 2))
        w, h = (int(v) for v in rng.integers(1, 3000, 2))
        for res in range(len(sizes)):
            assert piiif.map_region_to_level(x, y, w, h, sizes, res) == \
                jiiif.map_region_to_level(x, y, w, h, sizes, res)
        assert piris.metadata_document(sizes, tile) == jiris.metadata_document(sizes, tile)
        for layer in (-1, 0, len(sizes) - 1, len(sizes)):
            assert piris.layer_grid(sizes, layer, tile) == jiris.layer_grid(sizes, layer, tile)


# -- both fronts ----------------------------------------------------------------------

RENDER_C = "c=1|0:40000$FF0000,2|100:50000$00FF00"
DOCS = ["/dzi/1.dzi", "/dzi/9.dzi", f"/dzi/{BROKEN}.dzi", "/iiif/1/info.json",
        "/iiif/1/info.json?version=2", "/iiif/9/info.json", f"/iiif/{BROKEN}/info.json",
        "/iris/1/metadata", "/iris/9/metadata", f"/iris/{BROKEN}/metadata"]
TILES = [
    "/dzi/1_files/10/0_0.png", "/dzi/1_files/10/2_2.png", "/dzi/1_files/9/1_0.png",
    "/dzi/1_files/8/0_0.jpeg", "/dzi/1_files/10/1_1.png?" + RENDER_C,
    "/dzi/1_files/10/0_1.png?m=g&z=1", "/dzi/1_files/10/0_0.jpg?q=0.5",
    "/iiif/1/full/max/0/default.png", "/iiif/1/0,0,256,256/256,/0/default.png",
    "/iiif/1/0,0,512,512/256,256/0/gray.png", "/iiif/1/full/!200,200/0/default.png",
    "/iiif/1/100,50,300,200/max/360/color.jpg", "/iiif/1/full/,130/0/default.png?" + RENDER_C,
    "/iris/1/layers/2/tiles/0", "/iris/1/layers/2/tiles/8", "/iris/1/layers/0/tiles/0",
    "/iris/1/layers/1/tiles/1?format=jpg",
]
ERRORS = [
    ("/dzi/1_files/7/0_0.png", 404), ("/dzi/1_files/11/0_0.png", 404),
    ("/dzi/1_files/10/3_0.png", 404), ("/dzi/1_files/10/0_0.gif", 400),
    ("/dzi/9_files/10/0_0.png", 404), (f"/dzi/{BROKEN}_files/10/0_0.png", 503),
    ("/dzi/1_files/10/0_0.png?c=zz", 400), ("/dzi/1_files/10/0_0.png?c=5", 404),
    ("/dzi/1_files/10/0_0.png?z=zz", 400), ("/dzi/1_files/10/0_0.png?c=1$nosuchlut", 400),
    ("/iiif/1/pct:0,0,50,50/max/0/default.png", 501), ("/iiif/1/full/max/90/default.png", 501),
    ("/iiif/1/full/max/0/bitonal.png", 501), ("/iiif/1/full/max/0/default.gif", 501),
    ("/iiif/1/full/123,/0/default.png", 501), ("/iiif/1/1,2,3/max/0/default.png", 400),
    ("/iiif/1/full/max/0/weird.png", 400), ("/iiif/1/full/max/0/default", 400),
    ("/iiif/1/700,0,10,10/max/0/default.png", 400), ("/iiif/9/full/max/0/default.png", 404),
    (f"/iiif/{BROKEN}/full/max/0/default.png", 503), ("/iris/1/layers/3/tiles/0", 404),
    ("/iris/1/layers/2/tiles/9", 404), ("/iris/1/layers/2/tiles/0?format=gif", 400),
    (f"/iris/{BROKEN}/layers/0/tiles/0", 503), ("/iris/1/layers/x/tiles/0", 405),
    ("/dzi/1_files/10/0.png", 405), ("/iiif/1/full/max/0", 405),
]


async def test_documents_match_jax(image_path):
    """Descriptors, info.json (3.0 and 2.1) and Iris metadata: equal bodies
    and headers by GET and HEAD; 404 for an unknown image, 503 with
    ``Retry-After`` for an open breaker; 403 without a session."""
    async def body(f):
        for url in DOCS:
            for method in ("GET", "HEAD"):
                await f.both(method, url, COOKIE)
        status, hdrs, got = await f.both("GET", "/dzi/1.dzi", COOKIE)
        assert (status, hdrs["content-type"]) == (200, "application/xml")
        assert got == pdzi.descriptor_xml(600, 520, 256)
        status, hdrs, _ = await f.both("GET", f"/iris/{BROKEN}/metadata", COOKIE)
        assert (status, hdrs["retry-after"]) == (503, "3")
        assert (await f.both("GET", "/dzi/1.dzi", {"Host": "h"}))[0] == 403
    await with_fronts(image_path, body)


@pytest.mark.parametrize("part", range(3))
async def test_tiles_match_jax(image_path, part):
    """Adapter tiles of every dialect, miss then hit: equal bodies, ETags,
    Cache-Control, X-Cache; HEAD; 304 on a matching If-None-Match."""
    async def body(f):
        for url in TILES[part::3]:
            status, hdrs, got = await f.both("GET", url, COOKIE)
            assert (status, hdrs["x-cache"]) == (200, "miss"), url
            assert (await f.both("GET", url, COOKIE))[1]["x-cache"] == "hit"
            status, head, got = await f.both("HEAD", url, COOKIE)
            assert (status, got, head["etag"]) == (200, b"", hdrs["etag"])
            status, _, got = await f.both("GET", url, {**COOKIE, "If-None-Match": hdrs["etag"]})
            assert (status, got) == (304, b"")
    await with_fronts(image_path, body)


async def test_errors_match_jax(image_path):
    """400, 404, 501, 503 and 405 answers, by GET and by HEAD (an empty
    HEAD answer carries no Content-Length in either), and 403 first
    without a session."""
    async def body(f):
        for url, want in ERRORS:
            status, hdrs, _ = await f.both("GET", url, COOKIE)
            assert status == want, url
            status, hdrs, got = await f.both("HEAD", url, COOKIE)
            assert status == want and got == b"", url
        for url in ("/iiif/1/full/max/0/default.png", "/iris/1/metadata"):
            assert (await f.both("GET", url, {"Host": "h"}))[0] == 403
            status, hdrs, _ = await f.both("POST", url, COOKIE)
            assert (status, hdrs["allow"]) == (405, "GET,HEAD,OPTIONS")
    await with_fronts(image_path, body)


# percent-escapes in adapter paths (the reference probe's answers: JAX
# first): aiohttp matches ``%2F`` as part of a segment and decodes it in
# the group, and keeps an escape that is not UTF-8 as written
ESCAPED = [
    ("/tile/%31/0/0/0?w=64&h=64", 200), ("/tile/%2B1/0/0/0?w=64&h=64", 200),
    ("/tile/1/0/1/%201", 404), ("/tile/1%2F0/0/0/0", 400),
    ("/iiif/1/full%2Fmax/0/default.png", 405), ("/dzi/1_files/10%2F0_0.png", 405),
    ("/iiif/1/full/max/0/default.png%2F", 501), ("/iiif/1/full/max/0/%FF.png", 400),
    ("/iiif/1/full/max/0/%C3%A9.png", 400), ("/iiif/1/info%2Ejson", 200),
    ("/iris/1/%6detadata", 200), ("/dzi/%31.dzi", 200), ("/tile/1/1/1/0?x=%FF", 400),
]


async def _raw(port, target):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"GET {target} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                     f"Cookie: sessionid=ck\r\n\r\n".encode())
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    top, _, body = raw.partition(b"\r\n\r\n")
    lines = top.decode("latin-1").split("\r\n")
    hdrs = {k.lower(): v for k, v in (ln.split(": ", 1) for ln in lines[1:])}
    return int(lines[0].split()[1]), {k: hdrs.get(k) for k in COMPARED}, body


async def test_escaped_paths_match_jax(image_path):
    """Each escaped URL as the same raw bytes to both fronts: equal
    statuses, compared headers and bodies."""
    async def body(f):
        for url, want in ESCAPED:
            jax = await _raw(f.jax.server.port, url)
            port = await _raw(f.port_no, url)
            assert port == jax, url
            assert port[0] == want, url
    await with_fronts(image_path, body)


EQUIVALENT = [
    ("/dzi/1_files/10/1_0.png", "/render/1/0/0/0?x=256&y=0&w=256&h=256&resolution=0"
                                "&format=png"),
    ("/dzi/1_files/9/1_1.png?" + RENDER_C,
     "/render/1/0/0/0?x=256&y=256&w=44&h=4&resolution=1&format=png&" + RENDER_C),
    ("/iiif/1/0,0,512,512/256,256/0/gray.png",
     "/render/1/0/0/0?x=0&y=0&w=256&h=256&resolution=1&format=png&m=g"),
    ("/iris/1/layers/2/tiles/8", "/render/1/0/0/0?x=512&y=512&w=88&h=8&resolution=0"
                                 "&format=png"),
]


@pytest.mark.parametrize("adapter_first", [True, False])
async def test_adapter_tiles_share_native_entries(image_path, adapter_first):
    """An adapter tile and its native /render request: the same bytes and
    ETag, and whichever comes second is a cache hit, in both fronts."""
    async def body(f):
        for adapter, native in EQUIVALENT:
            first, second = (adapter, native) if adapter_first else (native, adapter)
            s1, h1, b1 = await f.both("GET", first, COOKIE)
            s2, h2, b2 = await f.both("GET", second, COOKIE)
            assert (s1, s2, h1["x-cache"], h2["x-cache"]) == (200, 200, "miss", "hit"), first
            assert (b1, h1["etag"]) == (b2, h2["etag"])
        view = f.port.health()
        assert view["protocols"]["dzi"] and view["protocols"]["iiif"] and \
            view["protocols"]["iris"]
        assert sum(view["protocols"]["requests"].values()) > 0
    await with_fronts(image_path, body)
