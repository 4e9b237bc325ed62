"""The port's entry point as a deployment runs it, in subprocesses on the
CPU: ``python -m omero_ms_pixel_buffer_tpu_torch --config FILE --device
cpu`` with Redis sessions in a RESP stub answers 403 for an unknown
session and a 200 PNG whose bytes equal the JAX pipeline's for the same
lone request, and exits 0 on SIGTERM; ``debug-context`` prints the
wiring; ``--dev --registry`` with no config file serves; a config that
turns on a plane the port lacks exits 2 naming the key. Tolerance: zero
(statuses, bytes, exit codes)."""

import asyncio
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu_torch.cache.plane.resp_stub import InMemoryRespServer

from test_auth_dispatch import _django_signed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = np.random.default_rng(5).integers(0, 60000, (1, 1, 1, 200, 300), dtype=np.uint16)
TILE = "/tile/1/0/0/0?x=40&y=20&w=128&h=96&format=png"
ENV = {**os.environ, "PYTHONPATH": ROOT, "OMPB_DISABLE_NATIVE": "1"}


@pytest.fixture
def registry(tmp_path):
    path = str(tmp_path / "img.ome.tiff")
    write_ome_tiff(path, IMG, tile_size=(64, 64))
    reg = tmp_path / "registry.json"
    reg.write_text(json.dumps({"images": [{"id": 1, "path": path}]}))
    return str(reg)


class StubThread:
    def __init__(self):
        self.stub = InMemoryRespServer()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.port = asyncio.run_coroutine_threadsafe(self.stub.start(), self.loop).result(10)

    def close(self):
        asyncio.run_coroutine_threadsafe(self.stub.close(), self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def _start(args, cwd):
    proc = subprocess.Popen([sys.executable, "-m", "omero_ms_pixel_buffer_tpu_torch", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
                            env=ENV, cwd=cwd)
    line = proc.stdout.readline()
    if not line.startswith("listening on"):
        proc.kill()
        proc.wait(10)
        pytest.fail(f"the port did not start: {line!r}")
    return proc, int(line.strip().rsplit(":", 1)[1])


def _get(port, path, cookie=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path, headers={"Cookie": f"sessionid={cookie}"} if cookie else {})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    return proc.wait(60)


def test_config_entry_point_serves_and_stops(tmp_path, registry):
    stub = StubThread()
    try:
        stub.stub.data[b":1:django.contrib.sessions.cachegood"] = (
            _django_signed({"connector": {"omero_session_key": "k1"}}), None)
        cfg = tmp_path / "config.yaml"
        cfg.write_text(f"session-store:\n  type: redis\n  uri: redis://127.0.0.1:{stub.port}/0\n"
                       f"image-registry: {registry}\nport: 0\n")
        proc, port = _start(["--config", str(cfg), "--device", "cpu"], str(tmp_path))
        try:
            assert _get(port, TILE, "unknown")[0] == 403
            assert _get(port, TILE)[0] == 403
            status, body = _get(port, TILE, "good")
            assert status == 200
        finally:
            assert _stop(proc) == 0
    finally:
        stub.close()
    # the JAX pipeline's bytes for the same lone request (the host route a
    # batch of one takes in both packages)
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry, PixelsService
    from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef, TileCtx

    reg = ImageRegistry(registry)
    pipeline = TilePipeline(PixelsService(reg), engine="device", buckets=(256, 512))
    try:
        want = pipeline.handle(TileCtx(1, 0, 0, 0, RegionDef(40, 20, 128, 96), format="png",
                                       omero_session_key="k1"))
    finally:
        pipeline.close()
    assert body == want


def test_debug_context_prints_the_wiring(tmp_path, registry):
    out = subprocess.run(
        [sys.executable, "-m", "omero_ms_pixel_buffer_tpu_torch", "debug-context",
         "--config", os.path.join(ROOT, "conf", "config.yaml"), "--registry", registry,
         "--device", "cpu"], capture_output=True, text=True, timeout=300, env=ENV,
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    for prefix in ("config:", "session store: RedisSessionStore", "pixels service:",
                   "pipeline: device=cpu", "kernels:", "native engine:", "absent planes:"):
        assert any(ln.startswith(prefix) for ln in lines), (prefix, out.stdout)
    assert "images registered: 1" in out.stdout
    assert "absent planes: none" in lines


def test_dev_registry_without_a_config_file_serves(tmp_path, registry):
    proc, port = _start(["--dev", "--registry", registry, "--device", "cpu", "--port", "0",
                         "--deflate-mode", "rle"], str(tmp_path))
    try:
        assert not os.path.exists(tmp_path / "conf" / "config.yaml")
        status, body = _get(port, TILE, "any-cookie")
        assert status == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
        assert _get(port, TILE)[0] == 403
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert health["queue"]["deflate_mode"] == "rle"
        assert health["config"]["session_store"] == "EchoSessionStore"
    finally:
        assert _stop(proc) == 0


@pytest.mark.parametrize("block,named", [
    ("backend:\n  batching:\n    device-encode: false\n", "backend.batching.device-encode"),
    ("backend:\n  engine: host\n", "backend.engine"),
])
def test_unsupported_plane_exits_2_naming_the_key(tmp_path, block, named):
    cfg = tmp_path / "config.yaml"
    cfg.write_text("session-store:\n  type: memory\n" + block)
    out = subprocess.run(
        [sys.executable, "-m", "omero_ms_pixel_buffer_tpu_torch", "--config", str(cfg),
         "--device", "cpu", "--port", "0"], capture_output=True, text=True, timeout=300,
        env=ENV, cwd=str(tmp_path))
    assert out.returncode == 2
    assert f"'{named}'" in out.stderr and "ROADMAP.md" in out.stderr


def test_ingest_and_mesh_config_starts_writes_and_exits_0(tmp_path):
    """``ingest.enabled: true`` with ``mesh.probe-interval-ms: 500`` (once
    refused with exit code 2) start from ``--config``: a ``PUT`` commits,
    the tile reads back, ``/healthz`` counts the commit, and SIGTERM exits
    0."""
    from omero_ms_pixel_buffer_tpu.io.zarr import write_ngff

    root = str(tmp_path / "img.zarr")
    write_ngff(root, IMG, chunks=(32, 32), levels=1, zarr_format=3, shards=(64, 64))
    reg = tmp_path / "registry.json"
    reg.write_text(json.dumps({"images": [{"id": 1, "path": root}]}))
    cfg = tmp_path / "config.yaml"
    cfg.write_text(f"session-store:\n  type: memory\nimage-registry: {reg}\nport: 0\n"
                   "ingest:\n  enabled: true\nmesh:\n  probe-interval-ms: 500\n")
    proc, port = _start(["--config", str(cfg), "--dev", "--device", "cpu"], str(tmp_path))
    try:
        tile = np.arange(32 * 32, dtype=np.uint16).reshape(32, 32)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("PUT", "/image/1/tile/0/0/0?x=32&y=0&w=32&h=32",
                     body=tile.astype(">u2").tobytes(), headers={"Cookie": "sessionid=k"})
        r = conn.getresponse()
        assert r.status == 200, r.read()
        assert json.loads(r.read())["tiles"] == 1
        conn.close()
        status, body = _get(port, "/tile/1/0/0/0?x=32&y=0&w=32&h=32", "k")
        assert status == 200 and body == tile.astype(">u2").tobytes()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert health["ingest"]["commits"] == 1 and health["ingest"]["enabled"] is True
    finally:
        assert _stop(proc) == 0


@pytest.mark.parametrize("mode", ["gossip", "lease"])
def test_membership_config_starts_serves_and_exits_0(tmp_path, registry, mode):
    """``cluster.gossip.enabled`` and ``cluster.lease-ttl-s`` (once refused
    with exit code 2) start the replica from ``--config``: it serves a
    tile, ``/healthz`` shows its membership view (the lease in the RESP
    stub's store), and SIGTERM drains it and exits 0."""
    stub = StubThread()
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self_port = s.getsockname()[1]
        me = f"http://127.0.0.1:{self_port}"
        block = (f"    enabled: true\n    interval-s: 0.2\n" if mode == "gossip" else "")
        cfg = tmp_path / "config.yaml"
        cfg.write_text(
            f"session-store:\n  type: memory\nimage-registry: {registry}\nport: {self_port}\n"
            f"cluster:\n  members: [{me}]\n  self: {me}\n  secret: s\n"
            f"  l2:\n    uri: redis://127.0.0.1:{stub.port}/0\n"
            + (f"  gossip:\n{block}" if mode == "gossip" else "  lease-ttl-s: 1.5\n"))
        proc, port = _start(["--config", str(cfg), "--dev", "--device", "cpu",
                             "--deflate-mode", "rle"], str(tmp_path))
        try:
            status, body = _get(port, TILE, "any-cookie")
            assert status == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/healthz")
            health = json.loads(conn.getresponse().read())
            conn.close()
            view = health["cluster"]
            assert view["gossip"] == (mode == "gossip")
            assert view["membership"]["members"] == [me]
            assert "fleet_pressure" in health["slo"]
            assert f"ompb:cluster:member:{me}".encode() in stub.stub.data
        finally:
            assert _stop(proc) == 0
        # the drain's last step released the lease
        assert f"ompb:cluster:member:{me}".encode() not in stub.stub.data
    finally:
        stub.close()


def test_shipped_config_starts_and_a_dead_redis_answers_503(tmp_path, registry):
    """The shipped, unedited ``conf/config.yaml`` starts the port; its
    Redis (localhost:6379) does not answer here, so a request with a
    cookie answers 503 with ``Retry-After``, never 403; ``/healthz`` lists
    the five default-on planes started absent."""
    import socket

    with socket.socket() as s:
        if s.connect_ex(("127.0.0.1", 6379)) == 0:
            pytest.skip("something answers on localhost:6379")
    proc, port = _start(["--config", os.path.join(ROOT, "conf", "config.yaml"),
                         "--registry", registry, "--device", "cpu", "--port", "0"],
                        str(tmp_path))
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", TILE, headers={"Cookie": "sessionid=someone"})
        r = conn.getresponse()
        assert (r.status, r.getheader("Retry-After"), r.read()) == (
            503, "1", b"Session store unavailable")
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert health["config"]["absent"] == []
        assert health["config"]["session_store"] == "RedisSessionStore"
        assert _get(port, TILE)[0] == 403
    finally:
        assert _stop(proc) == 0
