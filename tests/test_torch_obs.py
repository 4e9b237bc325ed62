"""The port's observability plane against the JAX package's: the flight
recorder's keep and drop decisions, kept reasons, outcomes, wide events,
ring and counts, and the SLI layer's burn rates, in lockstep under one fake
clock (and one seeded id source) patched into both modules; the Zipkin
payloads of kept records' retro spans, posted by both reporters to one
sink stub; a port server with ``http-tracing.enabled`` and a
``zipkin-url`` exporting its spans to the sink; the process collector's
families. Scripts are made from a seed with numpy. Tolerance: zero."""

import http.server
import json
import random
import threading
import time

import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu.obs import recorder as jrec
from omero_ms_pixel_buffer_tpu.obs import sli as jsli
from omero_ms_pixel_buffer_tpu.resilience import breaker as jbreaker
from omero_ms_pixel_buffer_tpu.utils import process_metrics as jproc
from omero_ms_pixel_buffer_tpu.utils import tracing as jtracing
from omero_ms_pixel_buffer_tpu_torch.obs import recorder as prec
from omero_ms_pixel_buffer_tpu_torch.obs import sli as psli
from omero_ms_pixel_buffer_tpu_torch.resilience import breaker as pbreaker
from omero_ms_pixel_buffer_tpu_torch.utils import process_metrics as pproc
from omero_ms_pixel_buffer_tpu_torch.utils import tracing as ptracing

STATUSES = (200, 200, 200, 200, 304, 403, 404, 500, 503, 503, 504)
PATHS = ("/tile/1/0/0/0", "/render/2/0/0/0", "/dzi/4_files/13/3_2.png", "/histogram/2/0/0/0")


class FakeClock:
    """perf_counter, monotonic and time of one module, advanced by hand."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self) -> float:
        return self.now

    monotonic = perf_counter

    def time(self) -> float:
        return 1.7e9 + self.now


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock and one seeded id source per recorder module."""
    pair = (FakeClock(), FakeClock())
    for mod, clock in zip((jrec, prec), pair):
        monkeypatch.setattr(mod, "time", clock)
        monkeypatch.setattr(mod, "random", random.Random(11))
    return pair


def _script(recorder_mod, rec_obj, clock, seed: int):
    """Scripted requests through one recorder: (kept, reason, outcome,
    status) per request."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(60, 120))):
        tid = None if rng.random() < 0.5 else f"{int(rng.integers(0, 1 << 62)):032x}"
        rec = rec_obj.start(PATHS[int(rng.integers(0, len(PATHS)))], trace_id=tid)
        for _ in range(int(rng.integers(0, 6))):
            stage = recorder_mod.STAGES[int(rng.integers(0, len(recorder_mod.STAGES)))]
            dur = float(rng.exponential(0.02))
            clock.now += dur
            rec.stamp(stage, dur)
        rec.tag("priority", ("interactive", "prefetch", "bulk", "robot")[int(rng.integers(0, 4))])
        if rng.random() < 0.1:
            rec.tag("degraded", 1)
        if rng.random() < 0.1:
            rec.note_fault("store.http")
        status = STATUSES[int(rng.integers(0, len(STATUSES)))]
        if status == 503 and rng.random() < 0.5:
            rec.tag("shed_at", "queue")
        clock.now += float(rng.exponential(0.1))
        kept = rec_obj.complete(rec, status)
        out.append((kept, rec.keep_reason, rec.outcome, rec.status))
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("rate,slow_s", [(0.0, 0.3), (0.01, 0.3), (0.25, 0.05), (1.0, 0.3)])
def test_recorder_decisions_in_lockstep(clocks, seed, rate, slow_s):
    recorders = [mod.FlightRecorder(slow_threshold_s=slow_s, head_sample_rate=rate,
                                    ring_size=32, sli=sli.SliLayer(slow_s, clock=c.monotonic))
                 for mod, sli, c in ((jrec, jsli, clocks[0]), (prec, psli, clocks[1]))]
    runs = [_script(mod, r, c, seed)
            for mod, r, c in zip((jrec, prec), recorders, clocks)]
    assert runs[1] == runs[0]
    assert recorders[1].events() == recorders[0].events()
    assert recorders[1].events(limit=3) == recorders[0].events(limit=3)
    first = recorders[0].events()[-1:] and recorders[0].events()[-1]["trace_id"]
    if first:
        assert recorders[1].events(trace_id=first) == recorders[0].events(trace_id=first)
    assert recorders[1].snapshot() == recorders[0].snapshot()
    assert recorders[1].kept_count() == recorders[0].kept_count()


def test_disabled_recorder_mints_nothing():
    assert prec.FlightRecorder(enabled=False).start("/tile/1/0/0/0") is None
    assert prec.FlightRecorder().complete(None, 200) is False


@pytest.mark.parametrize("seed", range(4))
def test_sli_burn_rates_in_lockstep(seed):
    rng = np.random.default_rng(100 + seed)
    clocks = (FakeClock(), FakeClock())
    layers = [mod.SliLayer(0.3, clock=c.monotonic) for mod, c in zip((jsli, psli), clocks)]
    for _ in range(400):
        step = float(rng.exponential(20.0))
        cls = ("interactive", "prefetch", "bulk", "other")[int(rng.integers(0, 4))]
        latency = float(rng.exponential(0.2))
        error = bool(rng.random() < 0.05)
        for layer, clock in zip(layers, clocks):
            clock.now += step
            layer.record(cls, latency, error=error)
        assert layers[1].burn_rates() == layers[0].burn_rates()
    assert layers[1].snapshot() == layers[0].snapshot()


class _Sink:
    """A Zipkin v2 collector stub on 127.0.0.1: keeps every POSTed span."""

    def __init__(self):
        spans, lock = [], threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with lock:
                    spans.extend(json.loads(body))
                self.send_response(202)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.spans, self.lock = spans, lock
        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/api/v2/spans"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def take(self):
        with self.lock:
            out = list(self.spans)
            self.spans.clear()
        return out

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def sink():
    s = _Sink()
    yield s
    for tracing, breaker in ((jtracing, jbreaker), (ptracing, pbreaker)):
        tracing.configure(enabled=False, log_spans=False)
        breaker.BOARD.reset()
    s.close()


@pytest.mark.parametrize("seed", range(3))
def test_retro_spans_post_equal_payloads(clocks, sink, seed):
    """Kept records become one ``http:<path>`` root and one
    ``stage:<name>`` child per stamped stage: the same Zipkin documents
    from both packages."""
    payloads = []
    for mod, tracing, clock in ((jrec, jtracing, clocks[0]), (prec, ptracing, clocks[1])):
        tracing.configure(enabled=False, log_spans=False, zipkin_url=sink.url, tail=True)
        rec_obj = mod.FlightRecorder(slow_threshold_s=0.3, head_sample_rate=0.3)
        _script(mod, rec_obj, clock, seed)
        tracing.TRACER.reporter.close()  # flushes
        tracing.TRACER.reporter = None
        payloads.append(sorted(sink.take(), key=lambda d: (d["traceId"], d["id"])))
    assert payloads[0] and payloads[1] == payloads[0]
    names = {d["name"] for d in payloads[1]}
    assert any(n.startswith("http:/") for n in names)
    assert any(n.startswith("stage:") for n in names)


async def test_http_tracing_enabled_exports_spans(tmp_path, sink):
    """``http-tracing.enabled: true`` with a ``zipkin-url``: the port
    starts, and each request's live ``http:<path>`` span reaches the sink,
    in the flight record's trace for a serving route."""
    from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
    from omero_ms_pixel_buffer_tpu_torch.auth.stores import MemorySessionStore
    from omero_ms_pixel_buffer_tpu_torch.http.server import check_planes, wire
    from omero_ms_pixel_buffer_tpu_torch.utils.config import Config

    path = str(tmp_path / "img.ome.tiff")
    write_ome_tiff(path, np.zeros((1, 1, 1, 64, 64), np.uint16), tile_size=(64, 64))
    reg = tmp_path / "registry.json"
    reg.write_text(json.dumps({"images": [{"id": 1, "path": path}]}))
    config = Config.from_dict({
        "session-store": {"type": "memory"}, "image-registry": str(reg),
        "http-tracing": {"enabled": True, "zipkin-url": sink.url},
        "obs": {"head-sample-rate": 1.0}})
    assert check_planes(config) == []
    server = wire(config, session_store=MemorySessionStore({"ck": "k"}), device="cpu")
    port = await server.start("127.0.0.1", 0)
    try:
        import asyncio

        for target in ("/tile/1/0/0/0?w=32&h=32&format=png", "/healthz"):
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(f"GET {target} HTTP/1.1\r\nHost: x\r\nCookie: sessionid=ck\r\n"
                         "Connection: close\r\n\r\n".encode())
            await writer.drain()
            assert (await reader.read()).startswith(b"HTTP/1.1 200")
            writer.close()
        trace_id = server.recorder.events()[0]["trace_id"]
    finally:
        await server.close()  # flushes the reporter
        server.pipeline.close()
    spans = sink.take()
    by_name = {d["name"]: d for d in spans}
    assert set(by_name) == {"http:/tile/1/0/0/0", "http:/healthz"}
    assert by_name["http:/tile/1/0/0/0"]["traceId"] == trace_id
    assert by_name["http:/tile/1/0/0/0"]["localEndpoint"] == {
        "serviceName": "omero-ms-pixel-buffer-tpu"}


def test_dead_sink_drops_and_opens_the_breaker(sink):
    """A sink that refuses connections costs dropped spans, counted, and
    opens the ``tracing:zipkin`` breaker (then drops without posting)."""
    ptracing.configure(enabled=False, log_spans=False, zipkin_url="http://127.0.0.1:9/x",
                       tail=True)
    reporter = ptracing.TRACER.reporter
    reporter._post([{"id": "1"}])
    for _ in range(5):
        reporter._post([{"id": "2"}, {"id": "3"}])
    assert reporter.dropped == 11
    assert pbreaker.BOARD.snapshot()["tracing:zipkin"]["state"] == "open"
    samples = ptracing.SPANS_DROPPED._values
    assert samples[(("reason", "breaker_open"),)] >= 2


def test_process_collector_families_match_jax():
    def families(lines):
        return [ln.split()[2:] for ln in lines if ln.startswith("# TYPE")]

    for om in (False, True):
        jl = list(jproc.ProcessCollector("0.1.0").collect(openmetrics=om))
        pl = list(pproc.ProcessCollector("0.1.0").collect(openmetrics=om))
        assert families(pl) == families(jl)
        assert [ln for ln in pl if ln.startswith("# HELP")] == [
            ln for ln in jl if ln.startswith("# HELP")]
    reg = pproc.REGISTRY.__class__()
    assert pproc.install(reg) is pproc.install(reg)  # idempotent
    assert "build_info{version=" in reg.exposition()
    assert time.time() >= pproc._START


async def test_failed_encode_group_answers_500_and_shows_in_metrics(tmp_path, monkeypatch):
    """No fallback: a failing encode group answers 500 for its lanes; the
    flight records keep them (reason ``error``), the outcome histogram and
    the ring count them, and nothing of the group is cached."""
    import asyncio

    from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
    from omero_ms_pixel_buffer_tpu_torch.http.server import create_server
    from omero_ms_pixel_buffer_tpu_torch.obs import recorder as prec_mod

    path = str(tmp_path / "img.ome.tiff")
    write_ome_tiff(path, np.zeros((1, 1, 1, 256, 256), np.uint16), tile_size=(64, 64))
    reg = tmp_path / "registry.json"
    reg.write_text(json.dumps({"images": [{"id": 1, "path": path}]}))
    server = create_server(str(reg), dev=True, device="cpu", packer="scan",
                           head_sample_rate=0.0)

    def boom(*args, **kwargs):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(server.pipeline.dispatcher, "_stage_group", boom)
    kept = prec_mod.RECORDS_KEPT._values.get((("reason", "error"),), 0.0)
    errors = sum(prec_mod.HTTP_REQUEST_SECONDS._counts.get((("outcome", "error"),), []))
    port = await server.start("127.0.0.1", 0)

    async def get(target):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"GET {target} HTTP/1.1\r\nHost: x\r\nCookie: sessionid=d\r\n"
                     "Connection: close\r\n\r\n".encode())
        await writer.drain()
        raw = await reader.read()
        writer.close()
        return raw

    try:
        # two lanes at once: one batch, one encode group (a lone lane takes
        # the host route)
        raws = await asyncio.gather(*(get(f"/tile/1/0/0/0?x={x}&y=0&w=64&h=64&format=png")
                                      for x in (0, 64)))
        assert all(r.startswith(b"HTTP/1.1 500") for r in raws), raws
        assert server.pipeline.device_queue_snapshot()["failed"] >= 1
        assert prec_mod.RECORDS_KEPT._values[(("reason", "error"),)] == kept + 2
        assert sum(prec_mod.HTTP_REQUEST_SECONDS._counts[(("outcome", "error"),)]) == errors + 2
        events = server.recorder.events()
        assert [e["status"] for e in events] == [500, 500]
        assert all("device" in e["stages_ms"] for e in events)
        assert len(server.cache.memory) == 0
    finally:
        await server.close()
        server.pipeline.close()
