"""The ingest plane of the port against the JAX package's
(``tests/test_ingest.py``'s classes, held against the reference):
config, auth, write -> read identity, shard edge cases, validation, the
epoch-keyed shard-index memo, the scheduler pin, torn-write chaos and a
mixed-package two-replica fleet. After the same write sequence every
store object is byte-equal between the two packages (v2 unsharded, v3
unsharded and v3 sharded with its crc32c index; on a ``FileStore`` and on
an S3 stub that checks every SigV4 signature, payload hash included, and
through multipart uploads with the threshold lowered on both), and the
HTTP answers (status, body, ``Content-Type``) are equal. Inputs come from
``numpy.random.default_rng(24)``. Tolerance: zero (bytes and statuses)."""

import asyncio
import datetime
import functools
import gzip
import hashlib
import json
import os
import re
import shutil
import socket
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from aiohttp import ClientSession, WSMsgType, web
from aiohttp.test_utils import TestClient, TestServer

from omero_ms_pixel_buffer_tpu.auth.stores import MemorySessionStore as JaxMemoryStore
from omero_ms_pixel_buffer_tpu.http.server import PixelBufferApp
from omero_ms_pixel_buffer_tpu.ingest import IngestError as JaxIngestError
from omero_ms_pixel_buffer_tpu.ingest import IngestPlane as JaxIngestPlane
from omero_ms_pixel_buffer_tpu.ingest import ShardAssembler as JaxAssembler
from omero_ms_pixel_buffer_tpu.io import stores as jstores
from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JaxRegistry
from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JaxService
from omero_ms_pixel_buffer_tpu.io.zarr import ZarrPixelBuffer as JaxZarrBuffer
from omero_ms_pixel_buffer_tpu.io.zarr import write_ngff
from omero_ms_pixel_buffer_tpu.resilience.faultinject import INJECTOR as JAX_INJECTOR
from omero_ms_pixel_buffer_tpu.utils.config import Config as JaxConfig
from omero_ms_pixel_buffer_tpu_torch.auth.stores import MemorySessionStore
from omero_ms_pixel_buffer_tpu_torch.cache.plane.resp_stub import InMemoryRespServer
from omero_ms_pixel_buffer_tpu_torch.http.server import wire
from omero_ms_pixel_buffer_tpu_torch.ingest import IngestError, IngestPlane, ShardAssembler
from omero_ms_pixel_buffer_tpu_torch.io import stores as pstores
from omero_ms_pixel_buffer_tpu_torch.io.pixel_buffer import BlockCache
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.io.stores import sigv4_headers
from omero_ms_pixel_buffer_tpu_torch.io.zarr import ZarrPixelBuffer
from omero_ms_pixel_buffer_tpu_torch.resilience.faultinject import INJECTOR, Fail, always, first_n
from omero_ms_pixel_buffer_tpu_torch.utils.config import Config, ConfigError

rng = np.random.default_rng(24)
IMG = rng.integers(0, 4096, (1, 2, 2, 96, 128), dtype=np.uint16)
AUTH = {"Cookie": "sessionid=ck"}
ACCESS_KEY = "AKIAINGEST0001"
SECRET_KEY = "ingest/secret/key"
BUCKET = "ingest-bucket"
# layouts of the store matrix: (name, write_ngff keywords)
LAYOUTS = {
    "v2": {"zarr_format": 2},
    "v2-blosc": {"zarr_format": 2, "compressor": "blosc-lz4"},
    "v3": {"zarr_format": 3},
    "v3-sharded": {"zarr_format": 3, "shards": (64, 64)},
}


class _FixedClock:
    @staticmethod
    def time():
        return 1.7e9


@pytest.fixture(autouse=True)
def _gzip_clock(monkeypatch):
    """A gzip member's header holds the time it was written (both
    packages' v3 ``gzip`` codec): one clock, so two writes a second apart
    still make equal objects."""
    monkeypatch.setattr(gzip, "time", _FixedClock)


@pytest.fixture(autouse=True)
def _clean_injectors():
    INJECTOR.clear()
    JAX_INJECTOR.clear()
    yield
    INJECTOR.clear()
    JAX_INJECTOR.clear()


def _write_zarr(root, layout="v3-sharded", levels=2):
    write_ngff(root, IMG, chunks=(32, 32), levels=levels, **LAYOUTS[layout])
    return root


def _wire(arr2d):
    """A tile body on the wire: raw big-endian pixels (the raw /tile
    read's byte order)."""
    return np.asarray(arr2d).astype(">u2").tobytes()


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _assert_same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for key in ta:
        assert ta[key] == tb[key], key


_AUTH = re.compile(r"AWS4-HMAC-SHA256 Credential=([^/]+)/\d+/([^/]+)/s3/aws4_request, "
                   r"SignedHeaders=([^,]+), Signature=([0-9a-f]+)")


class S3Stub:
    """A path-style S3 endpoint on 127.0.0.1: GET (signed ranges, 206), PUT
    of an object or a multipart part, the multipart upload's create,
    complete and abort. Every SigV4 signature is checked with the known
    secret, the payload's sha256 included. Objects live under
    ``root/<bucket>/<key>``; ``calls`` counts requests by kind."""

    def __init__(self, root: str):
        self.root = root
        self.calls: dict = {}
        self.uploads: dict = {}
        self.lock = threading.Lock()
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), functools.partial(_Handler, self))
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def count(self, kind: str) -> None:
        with self.lock:
            self.calls[kind] = self.calls.get(kind, 0) + 1

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def __init__(self, stub, *args, **kwargs):
        self.stub = stub
        super().__init__(*args, **kwargs)

    def log_message(self, *args):
        pass

    def _reply(self, code, body=b""):
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _verified(self, body: bytes):
        """(path, query) of a correctly signed request, else None after a
        403 answer."""
        m = _AUTH.match(self.headers.get("Authorization", ""))
        if m is None or m.group(1) != ACCESS_KEY:
            self._reply(403, b"AccessDenied")
            return None
        _, region, signed, signature = m.groups()
        payload = self.headers.get("x-amz-content-sha256", "")
        if self.command != "GET" and payload != hashlib.sha256(body).hexdigest():
            self._reply(403, b"XAmzContentSHA256Mismatch")
            return None
        path, _, raw_query = self.path.partition("?")
        query = dict(urllib.parse.parse_qsl(raw_query, keep_blank_values=True))
        rng = self.headers.get("Range")
        if rng is not None and "range" not in signed.split(";"):
            self._reply(403, b"unsigned Range")
            return None
        now = datetime.datetime.strptime(self.headers.get("x-amz-date", ""),
                                         "%Y%m%dT%H%M%SZ").replace(tzinfo=datetime.timezone.utc)
        want = sigv4_headers(self.command, self.headers["Host"], path, region, ACCESS_KEY,
                             SECRET_KEY, payload_sha256=payload, now=now,
                             extra_headers={"range": rng} if rng else None,
                             query=query or None)
        if want["authorization"].rsplit("Signature=", 1)[1] != signature:
            self._reply(403, b"SignatureDoesNotMatch")
            return None
        return path, query

    def _file(self, path: str) -> str:
        rel = urllib.parse.unquote(path.lstrip("/"))
        if ".." in rel.split("/"):
            raise ValueError(rel)
        return os.path.join(self.stub.root, rel)

    def _body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", "0") or 0))

    def do_GET(self):
        got = self._verified(b"")
        if got is None:
            return
        self.stub.count("GET")
        path = self._file(got[0])
        if not os.path.isfile(path):
            return self._reply(404, b"NoSuchKey")
        with open(path, "rb") as f:
            data = f.read()
        rng = self.headers.get("Range")
        if rng is None:
            return self._reply(200, data)
        spec = rng.split("=", 1)[1]
        if spec.startswith("-"):
            body = data[-int(spec[1:]):]
        else:
            lo, _, hi = spec.partition("-")
            body = data[int(lo):(int(hi) + 1 if hi else len(data))]
        self._reply(206, body)

    def do_PUT(self):
        body = self._body()
        got = self._verified(body)
        if got is None:
            return
        path, query = got
        if "uploadId" in query:
            self.stub.count("UploadPart")
            with self.stub.lock:
                parts = self.stub.uploads.get(query["uploadId"])
                if parts is None:
                    return self._reply(404, b"NoSuchUpload")
                parts[int(query["partNumber"])] = body
            return self._reply(200)
        self.stub.count("PUT")
        target = self._file(path)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with open(target, "wb") as f:
            f.write(body)
        self._reply(200)

    def do_POST(self):
        body = self._body()
        got = self._verified(body)
        if got is None:
            return
        path, query = got
        if "uploads" in query:
            self.stub.count("CreateMultipartUpload")
            with self.stub.lock:
                upload_id = f"up{len(self.stub.uploads) + 1}"
                self.stub.uploads[upload_id] = {}
            return self._reply(200, f"<InitiateMultipartUploadResult><UploadId>{upload_id}"
                                    f"</UploadId></InitiateMultipartUploadResult>".encode())
        self.stub.count("CompleteMultipartUpload")
        with self.stub.lock:
            parts = self.stub.uploads.pop(query.get("uploadId", ""), None)
        if parts is None:
            return self._reply(404, b"NoSuchUpload")
        listed = [int(n) for n in re.findall(rb"<PartNumber>(\d+)</PartNumber>", body)]
        etags = re.findall(rb"<ETag>&quot;([0-9a-f]+)&quot;</ETag>", body)
        for n, etag in zip(listed, etags):
            if hashlib.md5(parts.get(n, b"")).hexdigest().encode() != etag:
                return self._reply(200, b"<Error><Code>InvalidPart</Code></Error>")
        target = self._file(path)
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with open(target, "wb") as f:
            f.write(b"".join(parts[n] for n in listed))
        self._reply(200, b"<CompleteMultipartUploadResult/>")

    def do_DELETE(self):
        got = self._verified(b"")
        if got is None:
            return
        self.stub.count("AbortMultipartUpload")
        with self.stub.lock:
            self.stub.uploads.pop(got[1].get("uploadId", ""), None)
        self._reply(204)


# ---------------------------------------------------------------------------
# both fronts over their own copy of one image
# ---------------------------------------------------------------------------


async def _raw(port, method, path, headers=None, body=b"", chunks=None):
    """One raw HTTP/1.1 request; (status, lower-cased headers, body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        head = f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n"
        for k, v in (headers or {}).items():
            head += f"{k}: {v}\r\n"
        if chunks is not None:
            head += "Transfer-Encoding: chunked\r\n\r\n"
            payload = b"".join(b"%x\r\n%s\r\n" % (len(c), c) for c in chunks) + b"0\r\n\r\n"
        else:
            head += f"Content-Length: {len(body)}\r\n\r\n"
            payload = body
        writer.write(head.encode() + payload)
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    top, _, out = raw.partition(b"\r\n\r\n")
    lines = top.decode("latin-1").split("\r\n")
    hdrs = {k.lower(): v for k, v in (ln.split(": ", 1) for ln in lines[1:])}
    return int(lines[0].split()[1]), hdrs, out


class _JaxDenyWrite(JaxRegistry):
    """A permission-scoped registry that refuses every write."""

    def get_pixels(self, image_id, session_key=None):
        return super().get_pixels(image_id)

    def can_write_image(self, image_id, session_key):
        return False


class _PortDenyWrite(ImageRegistry):
    def get_pixels(self, image_id, session_key=None):
        return super().get_pixels(image_id)

    def can_write_image(self, image_id, session_key):
        return False


def _config(extra=None) -> dict:
    raw = {"session-store": {"type": "memory"},
           "backend": {"batching": {"coalesce-window-ms": 1.0}},
           "cache": {"prefetch": {"enabled": False}}, "ingest": {"enabled": True}}
    raw.update(extra or {})
    return raw


class Fronts:
    """The JAX app and the port's server, each over its own copy of one
    Zarr image (writes mutate it); ``both`` sends the same raw request to
    each and asserts the answers agree."""

    async def start(self, tmp_path, layout="v3-sharded", levels=2, extra=None, deny=False,
                    src=None):
        if src is None:  # one fixture, copied: both stores start byte-equal
            src = _write_zarr(str(tmp_path / "src-img.zarr"), layout, levels)
        self.roots = {}
        for name in ("jax", "port"):
            self.roots[name] = str(tmp_path / f"{name}-img.zarr")
            shutil.copytree(src, self.roots[name])
        raw = _config(extra)
        jreg = (_JaxDenyWrite if deny else JaxRegistry)()
        jreg.add(1, self.roots["jax"])
        self.jax_app = PixelBufferApp(JaxConfig.from_dict(raw), pixels_service=JaxService(jreg),
                                      session_store=JaxMemoryStore({"ck": "omero-key-1"}))
        self.jax = TestClient(TestServer(self.jax_app.make_app()),
                              loop=asyncio.get_running_loop())
        await self.jax.start_server()
        preg = (_PortDenyWrite if deny else ImageRegistry)()
        preg.add(1, self.roots["port"])
        self.port = wire(Config.from_dict(raw), pixels_service=PixelsService(preg),
                         session_store=MemorySessionStore({"ck": "omero-key-1"}), device="cpu")
        self.port_no = await self.port.start("127.0.0.1", 0)
        return self

    async def close(self):
        await self.jax.close()
        await self.port.close()

    async def both(self, method, path, headers=None, body=b"", chunks=None, compare_body=True):
        js, jh, jb = await _raw(self.jax.port, method, path, headers, body, chunks)
        ps, ph, pb = await _raw(self.port_no, method, path, headers, body, chunks)
        assert ps == js, (method, path, ps, js, pb[:200], jb[:200])
        if compare_body:
            assert pb == jb, (method, path, pb[:200], jb[:200])
        if jb and ps != 413:
            assert ph.get("content-type") == jh.get("content-type"), (method, path)
        return ps, ph, pb

    def same_stores(self):
        _assert_same_tree(self.roots["jax"], self.roots["port"])


async def _fronts(tmp_path, **kw) -> Fronts:
    return await Fronts().start(tmp_path, **kw)


async def _read_raw(f, z, c, t, x, y, w, h, extra=""):
    status, _, body = await f.both("GET", f"/tile/1/{z}/{c}/{t}?x={x}&y={y}&w={w}&h={h}{extra}",
                                   AUTH)
    assert status == 200, body
    return body


# ---------------------------------------------------------------------------
# config: the ingest: block
# ---------------------------------------------------------------------------


class TestIngestConfig:
    BASE = {"session-store": {"type": "memory"}}

    def test_defaults_off(self):
        cfg, jcfg = Config.from_dict(dict(self.BASE)), JaxConfig.from_dict(dict(self.BASE))
        assert cfg.ingest.enabled is jcfg.ingest.enabled is False
        assert cfg.ingest.max_inflight_shards == jcfg.ingest.max_inflight_shards == 64
        assert cfg.ingest.staging_bytes == jcfg.ingest.staging_bytes == 256 << 20

    @pytest.mark.parametrize("block", [{"enabled": True, "max-shards": 2},
                                       {"max-inflight-shards": "lots"}, {"staging-bytes": 0}],
                             ids=["unknown-key", "not-a-number", "zero-bytes"])
    def test_bad_blocks_fail_startup(self, block):
        with pytest.raises(ConfigError) as ei:
            Config.from_dict({**self.BASE, "ingest": block})
        with pytest.raises(Exception) as ji:
            JaxConfig.from_dict({**self.BASE, "ingest": block})
        assert str(ei.value) == str(ji.value)

    async def test_disabled_removes_routes(self, tmp_path):
        f = await _fronts(tmp_path, extra={"ingest": {"enabled": False}})
        try:
            for method, path, body in (
                    ("PUT", "/image/1/tile/0/0/0?x=0&y=0&w=32&h=32", b"\0" * 2048),
                    ("POST", "/image/1/planes?planes=0:0:0", b"\0")):
                status, hdrs, _ = await f.both(method, path, AUTH, body)
                assert status == 405 and hdrs.get("allow") == "OPTIONS"
        finally:
            await f.close()

    async def test_wrong_method_on_a_write_route_is_405(self, tmp_path):
        f = await _fronts(tmp_path)
        try:
            for method, path, allow in (("GET", "/image/1/planes?planes=0:0:0", "OPTIONS,POST"),
                                        ("POST", "/image/1/tile/0/0/0?x=0", "OPTIONS,PUT")):
                status, hdrs, _ = await f.both(method, path, AUTH)
                assert status == 405 and hdrs.get("allow") == allow
        finally:
            await f.close()


# ---------------------------------------------------------------------------
# auth
# ---------------------------------------------------------------------------


class TestIngestAuth:
    async def test_unauthenticated_403(self, tmp_path):
        f = await _fronts(tmp_path)
        try:
            status, _, _ = await f.both("PUT", "/image/1/tile/0/0/0?x=0&y=0&w=32&h=32", {},
                                        _wire(np.zeros((32, 32), np.uint16)))
            assert status == 403
            status, _, _ = await f.both("POST", "/image/1/planes?planes=0:0:0", {}, b"")
            assert status == 403
        finally:
            await f.close()

    async def test_write_denied_resolver_403(self, tmp_path):
        f = await _fronts(tmp_path, deny=True)
        try:
            status, _, body = await f.both("PUT", "/image/1/tile/0/0/0?x=0&y=0&w=32&h=32", AUTH,
                                           _wire(np.zeros((32, 32), np.uint16)))
            assert status == 403 and body == b"Cannot write Image:1"
            f.same_stores()
        finally:
            await f.close()


# ---------------------------------------------------------------------------
# write -> read identity, and the stores after it
# ---------------------------------------------------------------------------


class TestWriteReadIdentity:
    @pytest.mark.parametrize("layout", ["v2", "v3", "v3-sharded"])
    async def test_sequence_reads_back_and_stores_match(self, tmp_path, layout):
        """A tile, an edge tile, a two-plane append: equal answers, the
        written bytes read back from the raw /tile surface, neighbours
        kept, the stride-2 pyramid level follows, and every store object
        is byte-equal between the two packages."""
        f = await _fronts(tmp_path, layout=layout)
        try:
            tile = rng.integers(0, 4096, (40, 48), dtype=np.uint16)
            status, _, body = await f.both("PUT", "/image/1/tile/0/0/0?x=16&y=16&w=48&h=40",
                                           AUTH, _wire(tile))
            assert status == 200
            answer = json.loads(body)
            assert answer["tiles"] == 1 and answer["objects"] >= 1 and answer["epoch"] is None
            assert await _read_raw(f, 0, 0, 0, 16, 16, 48, 40) == _wire(tile)
            north = await _read_raw(f, 0, 0, 0, 0, 0, 128, 16)
            assert north == IMG[0, 0, 0, :16, :].astype(">u2").tobytes()
            edge = rng.integers(0, 4096, (32, 64), dtype=np.uint16)
            status, _, _ = await f.both("PUT", "/image/1/tile/1/1/0?x=64&y=64&w=64&h=32", AUTH,
                                        _wire(edge))
            assert status == 200
            planes = rng.integers(0, 4096, (2, 96, 128), dtype=np.uint16)
            status, _, body = await f.both("POST", "/image/1/planes?planes=1:0:0,1:1:0", AUTH,
                                           planes.astype(">u2").tobytes())
            assert status == 200 and json.loads(body)["tiles"] == 2
            for c in (0, 1):
                assert await _read_raw(f, 1, c, 0, 0, 0, 128, 96) == _wire(planes[c])
            expect = IMG[0, 0, 0].copy()
            expect[16:56, 16:64] = tile
            got = np.frombuffer(await _read_raw(f, 0, 0, 0, 0, 0, 64, 48, "&resolution=1"),
                                dtype=">u2").reshape(48, 64)
            assert np.array_equal(got, expect[::2, ::2])
            f.same_stores()
        finally:
            await f.close()

    async def test_every_read_surface_serves_the_new_bytes(self, tmp_path):
        """/tile PNG, /render, IIIF and DZI after a write: changed bodies,
        equal between the fronts (the caches did not serve the old ones)."""
        f = await _fronts(tmp_path)
        try:
            urls = ["/tile/1/0/0/0?x=0&y=0&w=64&h=64&format=png",
                    "/render/1/0/0/0?x=0&y=0&w=64&h=64",
                    "/iiif/1/full/128,96/0/default.png", "/dzi/1_files/7/0_0.png"]
            before = {}
            for url in urls:
                status, _, before[url] = await f.both("GET", url, AUTH)
                assert status == 200, url
            status, _, _ = await f.both("PUT", "/image/1/tile/0/0/0?x=0&y=0&w=64&h=64", AUTH,
                                        _wire(np.full((64, 64), 4095, np.uint16)))
            assert status == 200
            for url in urls:
                status, _, after = await f.both("GET", url, AUTH)
                assert status == 200 and after != before[url], url
        finally:
            await f.close()


# ---------------------------------------------------------------------------
# the store matrix: FileStore and S3 (single PUT and multipart)
# ---------------------------------------------------------------------------


class S3Env:
    """The S3 stub over ``root`` and the environment both packages' S3
    stores read (endpoint, keys, region)."""

    def __init__(self, root, monkeypatch):
        self.stub = S3Stub(root)
        monkeypatch.setenv("OMPB_S3_ENDPOINT", self.stub.endpoint)
        monkeypatch.setenv("AWS_ACCESS_KEY_ID", ACCESS_KEY)
        monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", SECRET_KEY)
        monkeypatch.setenv("AWS_REGION", "us-east-1")
        monkeypatch.delenv("AWS_SESSION_TOKEN", raising=False)


def _sequence():
    seq = np.random.default_rng(77)
    return [
        [(0, 0, 0, 16, 16, 48, 40, _wire(seq.integers(0, 4096, (40, 48), dtype=np.uint16)))],
        [(1, 1, 0, 64, 64, 64, 32, _wire(seq.integers(0, 4096, (32, 64), dtype=np.uint16))),
         (0, 1, 0, 0, 0, 8, 8, _wire(seq.integers(0, 4096, (8, 8), dtype=np.uint16)))],
        [(1, 0, 0, 0, 0, 128, 96, _wire(seq.integers(0, 4096, (96, 128), dtype=np.uint16)))],
    ]


@pytest.mark.parametrize("store", ["file", "s3", "s3-multipart"])
@pytest.mark.parametrize("layout", ["v2", "v2-blosc", "v3", "v3-sharded"])
def test_store_objects_match_after_the_same_writes(tmp_path, monkeypatch, layout, store):
    """The same write batches through both packages' ``IngestPlane``:
    the same stats, then every object byte-equal. On S3 every write is
    a signed PUT (or, with the threshold lowered on both stores, a
    multipart upload whose parts the stub checks against their ETags)."""
    root = tmp_path / "objects"
    src = str(tmp_path / "src.zarr")
    _write_zarr(src, layout)
    paths = {}
    for name in ("jax", "port"):
        shutil.copytree(src, str(root / BUCKET / f"{name}.zarr"))
        paths[name] = (str(root / BUCKET / f"{name}.zarr") if store == "file"
                       else f"s3://{BUCKET}/{name}.zarr")
    env = S3Env(str(root), monkeypatch) if store != "file" else None
    try:
        jreg, preg = JaxRegistry(), ImageRegistry()
        jreg.add(1, paths["jax"], type="zarr")
        preg.add(1, paths["port"], type="zarr")
        jsvc, psvc = JaxService(jreg), PixelsService(preg)
        if store == "s3-multipart":
            for svc in (jsvc, psvc):
                st = svc.get_pixel_buffer(1).store
                st.multipart_threshold, st.multipart_part_size = 512, 700
        jplane, pplane = JaxIngestPlane(jsvc), IngestPlane(psvc)
        for batch in _sequence():
            assert pplane.write_tiles(1, batch) == jplane.write_tiles(1, batch)
        assert pplane.snapshot() == jplane.snapshot()
        _assert_same_tree(str(root / BUCKET / "jax.zarr"), str(root / BUCKET / "port.zarr"))
        if store == "s3-multipart":
            assert env.stub.calls.get("CompleteMultipartUpload", 0) >= 2
        elif store == "s3":
            assert env.stub.calls.get("PUT", 0) >= 2 and "UploadPart" not in env.stub.calls
        jsvc.close()
        psvc.close()
    finally:
        if env is not None:
            env.stub.close()


def test_s3_put_signs_its_payload(tmp_path, monkeypatch):
    """Both packages' S3 PUT carries the same signed payload hash and
    reaches the stub, which refuses a wrong hash (403 -> StoreError)."""
    env = S3Env(str(tmp_path), monkeypatch)
    try:
        for mod in (jstores, pstores):
            store = mod.S3Store(f"s3://{BUCKET}/{mod.__name__.split('.')[0]}")
            store.put("a/b", b"payload")
            assert store.get("a/b") == b"payload"
            store.multipart_threshold, store.multipart_part_size = 4, 3
            store.put("a/c", b"0123456789")
            assert store.get("a/c") == b"0123456789"
        assert env.stub.calls["PUT"] == 2 and env.stub.calls["UploadPart"] == 8
        bad = pstores.S3Store(f"s3://{BUCKET}/x")
        bad._creds = (ACCESS_KEY, "not-the-secret", None)
        with pytest.raises(pstores.StoreError, match="403"):
            bad.put("k", b"v")
    finally:
        env.stub.close()


# ---------------------------------------------------------------------------
# shard edge cases, both packages
# ---------------------------------------------------------------------------


def _buffers(root_jax, root_port):
    return (JaxZarrBuffer(root_jax, image_id=1, cache_bytes=0),
            ZarrPixelBuffer(root_port, image_id=1, block_cache=BlockCache(0)))


def _twin_roots(tmp_path, **kw):
    src = _write_zarr(str(tmp_path / "src.zarr"), **kw)
    roots = [str(tmp_path / f"{name}.zarr") for name in ("jax", "port")]
    for root in roots:
        shutil.copytree(src, root)
    return roots


class TestShardEdgeCases:
    def _commit_both(self, roots, *stage):
        for buf, asm_cls in zip(_buffers(*roots), (JaxAssembler, ShardAssembler)):
            asm = asm_cls(buf)
            for args in stage:
                asm.stage_tile(*args)
            asm.commit()

    def test_partial_edge_shard(self, tmp_path):
        """96x128 in 64x64 shards: the bottom-right shard is partial and
        its out-of-grid positions stay sentinels."""
        roots = _twin_roots(tmp_path)
        tile = rng.integers(0, 4096, (32, 64), dtype=np.uint16)
        self._commit_both(roots, (0, 0, 0, 64, 64, 64, 32, tile))
        _assert_same_tree(*roots)
        full = _buffers(*roots)[1].get_tile_at(0, 0, 0, 0, 0, 0, 128, 96)
        expect = IMG[0, 0, 0].copy()
        expect[64:96, 64:128] = tile
        assert np.array_equal(full, expect)

    def test_sentinels_preserved_in_sparse_shard(self, tmp_path):
        roots = _twin_roots(tmp_path, levels=1)
        for root in roots:
            shutil.rmtree(os.path.join(root, "0", "c"))
        tile = rng.integers(0, 4096, (32, 32), dtype=np.uint16)
        self._commit_both(roots, (0, 0, 0, 0, 0, 32, 32, tile))
        _assert_same_tree(*roots)
        buf = _buffers(*roots)[1]
        assert np.array_equal(buf.get_tile_at(0, 0, 0, 0, 0, 0, 32, 32), tile)
        assert (buf.get_tile_at(0, 0, 0, 0, 32, 32, 32, 32) == buf.levels[0].fill_value).all()

    def test_index_location_start_spelling(self, tmp_path):
        roots = _twin_roots(tmp_path, levels=1)
        for root in roots:
            meta = os.path.join(root, "0", "zarr.json")
            with open(meta) as fh:
                doc = json.load(fh)
            for codec in doc["codecs"]:
                if codec.get("name") == "sharding_indexed":
                    codec["configuration"]["index_location"] = "start"
            with open(meta, "w") as fh:
                json.dump(doc, fh)
            shutil.rmtree(os.path.join(root, "0", "c"))
        assert _buffers(*roots)[1].levels[0].sharding.index_at_end is False
        tile = rng.integers(0, 4096, (48, 80), dtype=np.uint16)
        self._commit_both(roots, (0, 1, 0, 16, 8, 80, 48, tile))
        patch = rng.integers(0, 4096, (8, 8), dtype=np.uint16)
        self._commit_both(roots, (0, 1, 0, 0, 0, 8, 8, patch))  # parses its own index
        _assert_same_tree(*roots)
        buf = _buffers(*roots)[1]
        assert np.array_equal(buf.get_tile_at(0, 0, 1, 0, 16, 8, 80, 48), tile)
        assert np.array_equal(buf.get_tile_at(0, 0, 1, 0, 0, 0, 8, 8), patch)

    def test_non_zarr_image_and_http_store_409(self, tmp_path):
        path = str(tmp_path / "img.ome.tiff")
        write_ome_tiff(path, IMG, tile_size=(64, 64))
        errors = []
        for reg_cls, svc_cls, plane_cls, err in (
                (JaxRegistry, JaxService, JaxIngestPlane, JaxIngestError),
                (ImageRegistry, PixelsService, IngestPlane, IngestError)):
            reg = reg_cls()
            reg.add(1, path)
            with pytest.raises(err) as ei:
                plane_cls(svc_cls(reg)).write_tiles(1, [(0, 0, 0, 0, 0, 8, 8, b"\0" * 128)])
            errors.append((ei.value.code, ei.value.message))
        assert errors[0] == errors[1] and errors[1][0] == 409
        buf = _buffers(*_twin_roots(tmp_path / "h"))[1]
        buf.store = pstores.HTTPStore("http://127.0.0.1:9")
        with pytest.raises(IngestError) as ei:
            ShardAssembler(buf)
        assert ei.value.code == 409 and "read-only" in ei.value.message

    @pytest.mark.parametrize("bounds", [{"staging_bytes": 1024}, {"max_inflight_shards": 1}])
    def test_staging_and_shard_bounds_413(self, tmp_path, bounds):
        roots = _twin_roots(tmp_path)
        body = _wire(np.zeros((96, 128), np.uint16))
        errors = []
        for root, reg_cls, svc_cls, plane_cls, err in (
                (roots[0], JaxRegistry, JaxService, JaxIngestPlane, JaxIngestError),
                (roots[1], ImageRegistry, PixelsService, IngestPlane, IngestError)):
            reg = reg_cls()
            reg.add(1, root)
            plane = plane_cls(svc_cls(reg), **bounds)
            with pytest.raises(err) as ei:
                plane.write_tiles(1, [(0, 0, 0, 0, 0, 128, 96, body)])
            errors.append((ei.value.code, ei.value.message, plane.snapshot()))
        assert errors[0] == errors[1] and errors[1][0] == 413
        _assert_same_tree(*roots)


# ---------------------------------------------------------------------------
# request validation
# ---------------------------------------------------------------------------


class TestIngestValidation:
    async def test_client_errors_match_jax(self, tmp_path):
        f = await _fronts(tmp_path)
        try:
            cases = [
                ("PUT", "/image/1/tile/0/0/0", b""),
                ("PUT", "/image/1/tile/0/0/0?x=100&y=0&w=64&h=64", b"\0" * 8192),
                ("PUT", "/image/1/tile/0/0/0?x=0&y=0&w=32&h=32", b"\0" * 7),
                ("PUT", "/image/1/tile/9/0/0?x=0&y=0&w=32&h=32", b"\0" * 2048),
                ("PUT", "/image/1/tile/0/0/0?x=0&y=0&w=0&h=32", b""),
                ("PUT", "/image/x/tile/0/0/0?x=0&y=0&w=32&h=32", b"\0" * 2048),
                ("POST", "/image/1/planes?planes=zebra", b"\0" * 16),
                ("POST", "/image/1/planes?planes=0:0:0,1:0:0", b"\0" * 7),
                ("POST", "/image/1/planes?planes=0:0:0", b""),
            ]
            for method, url, body in cases:
                status, _, _ = await f.both(method, url, AUTH, body)
                assert status == 400, url
            for method, url in (("PUT", "/image/99/tile/0/0/0?x=0&y=0&w=32&h=32"),
                                ("POST", "/image/99/planes?planes=0:0:0")):
                status, _, _ = await f.both(method, url, AUTH, b"\0" * 2048)
                assert status == 404
            f.same_stores()
        finally:
            await f.close()


# ---------------------------------------------------------------------------
# the epoch-keyed shard-index memo
# ---------------------------------------------------------------------------


class TestShardIndexMemoEpoch:
    def test_memo_is_epoch_keyed_with_frozen_clock(self, tmp_path):
        root = _write_zarr(str(tmp_path / "img.zarr"), levels=1)
        reader = ZarrPixelBuffer(root, image_id=1, block_cache=BlockCache(0))
        arr = reader.levels[0]
        arr._shard_clock = lambda: 1000.0  # frozen: the TTL never expires
        assert np.array_equal(reader.get_tile_at(0, 0, 0, 0, 0, 0, 64, 64),
                              IMG[0, 0, 0, :64, :64])
        assert arr._shard_indexes
        tile = rng.integers(0, 4096, (64, 64), dtype=np.uint16)
        asm = ShardAssembler(ZarrPixelBuffer(root, image_id=1, block_cache=BlockCache(0)))
        asm.stage_tile(0, 0, 0, 0, 0, 64, 64, tile)
        asm.commit()
        assert reader.note_epoch(7) > 0
        assert np.array_equal(reader.get_tile_at(0, 0, 0, 0, 0, 0, 64, 64), tile)
        assert reader.note_epoch(7) == 0

    async def test_http_write_purges_reader_memo(self, tmp_path):
        f = await _fronts(tmp_path)
        try:
            old = await _read_raw(f, 0, 0, 0, 0, 0, 64, 64)
            buf = f.port.pipeline.pixels_service.get_pixel_buffer(1)
            for arr in buf.levels:
                arr._shard_clock = lambda: 1000.0
            tile = rng.integers(0, 4096, (64, 64), dtype=np.uint16)
            status, _, _ = await f.both("PUT", "/image/1/tile/0/0/0?x=0&y=0&w=64&h=64", AUTH,
                                        _wire(tile))
            assert status == 200
            new = await _read_raw(f, 0, 0, 0, 0, 0, 64, 64)
            assert new == _wire(tile) and new != old
        finally:
            await f.close()


# ---------------------------------------------------------------------------
# scheduler pin
# ---------------------------------------------------------------------------


class TestSchedulerPin:
    async def test_writes_acquire_nondegradable_and_never_train(self, tmp_path):
        f = await _fronts(tmp_path)
        try:
            sched = f.port.scheduler
            acquired, released, observed = [], [], []
            real_acquire, real_release = sched.acquire, sched.release

            async def spy_acquire(priority, deadline, degradable=True):
                acquired.append(degradable)
                return await real_acquire(priority, deadline, degradable=degradable)

            def spy_release(permit, train=True):
                released.append(train)
                return real_release(permit, train=train)

            sched.acquire, sched.release = spy_acquire, spy_release
            real_observe = f.port.sweep_detector.observe
            f.port.sweep_detector.observe = (
                lambda *a, **k: observed.append(a) or real_observe(*a, **k))
            tile = _wire(np.zeros((32, 32), np.uint16))
            for i in range(4):
                status, _, _ = await _raw(f.port_no, "PUT",
                                          f"/image/1/tile/0/0/0?x={i * 32}&y=0&w=32&h=32", AUTH,
                                          tile)
                assert status == 200
            assert acquired == [False] * 4
            assert released == [False] * 4
            assert observed == []
        finally:
            await f.close()


# ---------------------------------------------------------------------------
# torn-write chaos and epoch ordering
# ---------------------------------------------------------------------------


async def _port_raw_read(f, x=0, y=0, w=128, h=96):
    status, _, body = await _raw(f.port_no, "GET",
                                 f"/tile/1/0/0/0?x={x}&y={y}&w={w}&h={h}", AUTH)
    assert status == 200
    return body


class TestTornWriteChaos:
    @pytest.mark.parametrize("point,rule", [("ingest.commit", "first"), ("ingest.index", "always")])
    async def test_fault_serves_zero_mixed_reads(self, tmp_path, point, rule):
        """A fault at the publish point or the index rebuild: the write is
        a 503 in both packages and every byte still reads as before; the
        same write then lands once the fault is gone."""
        f = await _fronts(tmp_path)
        try:
            before = await _port_raw_read(f)
            for inj in (INJECTOR, JAX_INJECTOR):
                err = RuntimeError("disk died")
                inj.install(point, first_n(1, err) if rule == "first" else always(err))
            tile = rng.integers(0, 4096, (64, 64), dtype=np.uint16)
            url = "/image/1/tile/0/0/0?x=0&y=0&w=64&h=64"
            status, _, _ = await f.both("PUT", url, AUTH, _wire(tile))
            assert status == 503
            assert await _port_raw_read(f) == before
            f.same_stores()
            INJECTOR.clear()
            JAX_INJECTOR.clear()
            status, _, _ = await f.both("PUT", url, AUTH, _wire(tile))
            assert status == 200
            assert await _port_raw_read(f, w=64, h=64) == _wire(tile)
            f.same_stores()
        finally:
            await f.close()

    async def test_reads_racing_commits_never_mix(self, tmp_path):
        f = await _fronts(tmp_path)
        try:
            a = np.full((64, 64), 1111, dtype=np.uint16)
            b = np.full((64, 64), 2222, dtype=np.uint16)
            legal = {_wire(a), _wire(b), IMG[0, 0, 0, :64, :64].astype(">u2").tobytes()}
            INJECTOR.install("ingest.commit",
                             lambda n: Fail(RuntimeError("chaos")) if n % 3 == 2 else None)
            stop = asyncio.Event()
            mixed = []

            async def reader():
                while not stop.is_set():
                    got = await _port_raw_read(f, w=64, h=64)
                    if got not in legal:
                        mixed.append(got)
                    await asyncio.sleep(0)

            task = asyncio.create_task(reader())
            for i in range(12):
                status, _, _ = await _raw(f.port_no, "PUT", "/image/1/tile/0/0/0?x=0&y=0&w=64&h=64",
                                          AUTH, _wire(a if i % 2 == 0 else b))
                assert status in (200, 503)
            stop.set()
            await task
            assert mixed == []
        finally:
            await f.close()


# ---------------------------------------------------------------------------
# cross-replica: a mixed fleet, the write on one package, the read on the other
# ---------------------------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


async def _boot(kind, registry, members, self_url, port, l2_uri):
    raw = _config({"image-registry": registry,
                   "cluster": {"members": members, "self": self_url, "peer-timeout-ms": 3000,
                               "l2": {"uri": l2_uri}}})
    if kind == "port":
        server = wire(Config.from_dict(raw), device="cpu",
                      session_store=MemorySessionStore({"ck": "omero-key-1"}))
        await server.start("127.0.0.1", port)
        return server.close
    app = PixelBufferApp(JaxConfig.from_dict(raw),
                         session_store=JaxMemoryStore({"ck": "omero-key-1"}))
    runner = web.AppRunner(app.make_app())
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    return runner.cleanup


class TestCrossReplica:
    @pytest.mark.parametrize("writer", ["port", "jax"])
    async def test_write_on_a_invalidates_b_and_pushes_delta(self, tmp_path, writer):
        """A tile written on replica A (one package) is served fresh by
        replica B (the other) at once, through the epoch bump and the
        purge fan-out, and B's live channel gets the invalidation frame."""
        img = _write_zarr(str(tmp_path / "img.zarr"))
        registry = tmp_path / "registry.json"
        registry.write_text(json.dumps({"images": [{"id": 1, "path": img}]}))
        resp = InMemoryRespServer()
        await resp.start()
        kinds = [writer, "jax" if writer == "port" else "port"]
        ports = [_free_port() for _ in kinds]
        members = [f"http://127.0.0.1:{p}" for p in ports]
        closers = []
        try:
            for i, kind in enumerate(kinds):
                closers.append(await _boot(kind, str(registry), members, members[i], ports[i],
                                           resp.uri))
            url_a, url_b = members
            async with ClientSession() as http:
                r = await http.get(url_b + "/tile/1/0/0/0?x=0&y=0&w=64&h=64", headers=AUTH)
                assert r.status == 200
                old = await r.read()
                ws = await asyncio.wait_for(http.ws_connect(url_b + "/session/1/live",
                                                            headers=AUTH), 10)
                hello = json.loads((await asyncio.wait_for(ws.receive(), 10)).data)
                assert hello["type"] == "hello"
                tile = np.full((64, 64), 3333, dtype=np.uint16)
                r = await http.put(url_a + "/image/1/tile/0/0/0?x=0&y=0&w=64&h=64",
                                   data=_wire(tile), headers=AUTH)
                assert r.status == 200, await r.text()
                answer = await r.json()
                assert answer["epoch"] is not None and answer["tiles"] == 1
                frame = None
                for _ in range(10):
                    msg = await asyncio.wait_for(ws.receive(), 10)
                    assert msg.type == WSMsgType.TEXT
                    frame = json.loads(msg.data)
                    if frame.get("type") == "invalidate":
                        break
                assert frame["type"] == "invalidate" and frame["image"] == 1
                loop = asyncio.get_running_loop()
                deadline, fresh = loop.time() + 10, None
                while loop.time() < deadline:
                    r = await http.get(url_b + "/tile/1/0/0/0?x=0&y=0&w=64&h=64", headers=AUTH)
                    assert r.status == 200
                    fresh = await r.read()
                    if fresh == _wire(tile):
                        break
                    await asyncio.sleep(0.1)
                assert fresh == _wire(tile) and fresh != old
                await ws.close()
        finally:
            for close in closers:
                await close()
            await resp.close()
