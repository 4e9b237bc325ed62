"""The port's metrics registry (``utils/metrics.py``) against the JAX
package's, and ``/metrics`` through both fronts.

The same scripted observations (counters, gauges, histograms with and
without exemplars, callback gauges, a custom collector; values made from
a seed with numpy) go into a JAX ``Registry`` and a port ``Registry``:
the classic and the OpenMetrics bodies must be byte-equal, with the
exemplar timestamps patched to one clock in both modules. One deliberate
difference is pinned: a histogram whose buckets lack ``+Inf`` (the JAX
``io_requests_per_tile`` buckets end at 32.0) counts an observation of
33 requests a tile in the port's appended ``+Inf`` bucket, where the JAX
histogram raises.

Through both fronts (the JAX aiohttp app and the port's ``wire``, from one
config), after one request sequence: the ``/metrics`` family set (name and
kind) equals JAX's less the families of the planes the port does not have
(``ABSENT_PLANE_FAMILIES``), plus the port's own request-span histograms
and encode-queue merge counter (``PORT_SPAN_FAMILIES``), and the deltas of ``tiles_served_total``, the
result cache's hit and miss counts and ``tile_batches_dispatched_total``
are equal. Tolerance: zero."""

import asyncio
import json
import re

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import omero_ms_pixel_buffer_tpu.cache.prefetch  # noqa: F401 - declare every family
import omero_ms_pixel_buffer_tpu.models.device_dispatch  # noqa: F401
import omero_ms_pixel_buffer_tpu.render.analysis  # noqa: F401
import omero_ms_pixel_buffer_tpu.render.engine  # noqa: F401
import omero_ms_pixel_buffer_tpu.render.supertile  # noqa: F401
from omero_ms_pixel_buffer_tpu.auth.stores import MemorySessionStore as JaxMemoryStore
from omero_ms_pixel_buffer_tpu.cluster import brains as jbrains
from omero_ms_pixel_buffer_tpu.http.server import PixelBufferApp
from omero_ms_pixel_buffer_tpu.io import fetch as jfetch
from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu.utils import metrics as jm
from omero_ms_pixel_buffer_tpu.utils.config import Config as JaxConfig
from omero_ms_pixel_buffer_tpu_torch.auth.stores import MemorySessionStore
from omero_ms_pixel_buffer_tpu_torch.cluster import brains as pbrains
from omero_ms_pixel_buffer_tpu_torch.http.server import wire
from omero_ms_pixel_buffer_tpu_torch.io import fetch as pfetch
from omero_ms_pixel_buffer_tpu_torch.resilience import breaker as pbreaker
from omero_ms_pixel_buffer_tpu_torch.resilience import configure
from omero_ms_pixel_buffer_tpu_torch.utils import metrics as pm
from omero_ms_pixel_buffer_tpu_torch.utils.config import Config

# dynamic membership, gossip and the fleet brains, on /metrics in both
MEMBERSHIP_FAMILIES = {
    "cluster_brain_rounds_total", "cluster_fleet_pressure", "cluster_gossip_rounds_total",
    "cluster_membership_events_total", "slo_burn_rate_fleet",
}
# the session plane's families, on /metrics in both packages
SESSION_PLANE_FAMILIES = {"session_annotation_ops_total", "session_channel_events_total",
                          "session_pushes_total", "session_channels_live"}
# the recorder's hand-off and unclaimed time, and the groups the encode
# queue merged from its backlog (the JAX queue runs each group alone): the
# port's alone
PORT_SPAN_FAMILIES = {"request_handoff_seconds": "histogram",
                      "request_unclaimed_seconds": "histogram",
                      "device_encode_groups_merged_total": "counter"}


class _Clock:
    """The exemplar clock of both modules."""

    def __init__(self, t: float):
        self.t = t

    def time(self) -> float:
        self.t += 0.125
        return self.t

    @staticmethod
    def perf_counter() -> float:
        return 0.0


class _Collector:
    """A registry-compatible collector without the dialect argument."""

    def collect(self):
        yield "# HELP custom_things Things"
        yield "# TYPE custom_things gauge"
        yield 'custom_things{kind="a"} 3'


def _script(mod, seed: int):
    """The same observations into a fresh registry of ``mod``."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    c = reg.counter("ops_total", "Operations by kind")
    g = reg.gauge("depth", "Queue depth")
    h = reg.histogram("latency_seconds", "Latency")
    b = reg.histogram("lanes", "Lanes per batch", buckets=(1, 2, 4, 8, float("inf")))
    reg.gauge_fn("live_bytes", "Live bytes", lambda: {(("tier", "memory"),): 1234.5})
    reg.gauge_fn("broken", "A failing callback", lambda: 1 / 0)
    reg.gauge_fn("scalar", "A scalar callback", lambda: 7)
    reg.counter("never_total", "Never incremented")
    reg.register(_Collector())
    for i in range(int(rng.integers(20, 60))):
        kind = ("read", "write", "scan")[int(rng.integers(0, 3))]
        c.inc(float(rng.integers(1, 4)), kind=kind)
        g.set(float(rng.integers(0, 100)), queue=("a", "b")[i % 2])
        v = float(rng.exponential(0.05))
        h.observe(v, stage=("h2d", "compute")[i % 2],
                  exemplar=f"{int(rng.integers(0, 1 << 62)):032x}" if i % 3 == 0 else None)
        b.observe(int(rng.integers(1, 12)))
    h.attach_exemplar(0.003, "f" * 32, stage="h2d")
    h.attach_exemplar(0.003, "e" * 32, stage="never-observed")
    return reg, h


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("openmetrics", [False, True], ids=["classic", "openmetrics"])
def test_scripted_observations_render_byte_equal(monkeypatch, seed, openmetrics):
    monkeypatch.setattr(jm, "time", _Clock(1.7e9))
    monkeypatch.setattr(pm, "time", _Clock(1.7e9))
    jreg, jh = _script(jm, seed)
    preg, ph = _script(pm, seed)
    body = preg.exposition(openmetrics=openmetrics)
    assert body == jreg.exposition(openmetrics=openmetrics)
    assert body.endswith("# EOF\n") == openmetrics
    assert ("trace_id" in body) == openmetrics
    for q in (0.5, 0.9, 0.99):
        for stage in ("h2d", "compute", "none"):
            assert ph.quantile(q, stage=stage) == jh.quantile(q, stage=stage)


def test_io_requests_per_tile_counts_33_requests_in_inf():
    """The deliberate difference: 33 store requests for one tile."""
    buckets = jfetch.IO_REQUESTS_PER_TILE.buckets
    assert buckets[-1] == 32.0
    assert pfetch.IO_REQUESTS_PER_TILE.buckets == buckets + (float("inf"),)
    jh = jm.Registry().histogram("io_requests_per_tile", "x", buckets=buckets)
    with pytest.raises(IndexError):
        jh.observe(33.0)  # the JAX count list has no slot past 32.0
    reg = pm.Registry()
    ph = reg.histogram("io_requests_per_tile", "x", buckets=buckets)
    ph.observe(33.0)
    ph.observe(2.0)
    body = reg.exposition()
    assert 'io_requests_per_tile_bucket{le="32.0"} 1' in body
    assert 'io_requests_per_tile_bucket{le="+Inf"} 2' in body
    assert "io_requests_per_tile_count 2" in body
    assert "io_requests_per_tile_sum 35.0" in body


# -- /metrics through both fronts ---------------------------------------------------

IMG = np.random.default_rng(21).integers(0, 60000, (1, 3, 2, 256, 256), dtype=np.uint16)
COOKIE = {"Cookie": "sessionid=ck"}
REQUESTS = [
    "/tile/1/0/0/0?x=0&y=0&w=64&h=64&format=png",
    "/tile/1/0/0/0?x=0&y=0&w=64&h=64&format=png",
    "/tile/1/0/1/0?x=64&y=0&w=64&h=64",
    "/tile/1/0/0/0?x=64&y=64&w=100&h=40&format=tif",
    "/render/1/0/0/0?x=0&y=0&w=128&h=128&c=1|0:60000$FF0000,2|0:60000$00FF00",
    "/render/1/0/0/0?x=0&y=0&w=128&h=128&c=1|0:60000$FF0000,2|0:60000$00FF00",
    "/histogram/1/0/0/0?x=0&y=0&w=128&h=128&bins=64",
    "/tile/9/0/0/0?format=png",
    "/tile/1/0/0/0?x=250&y=0&w=64&h=64&format=png",
]
_TYPE = re.compile(r"^# TYPE (\S+) (\S+)$", re.M)
_SAMPLE = re.compile(r"^(\w+)(\{[^}]*\})? (\S+)$", re.M)


def _families(body: str) -> dict:
    return dict(_TYPE.findall(body))


def _samples(body: str) -> dict:
    return {(n, labels or ""): float(v) for n, labels, v in _SAMPLE.findall(body)}


def _delta(after: dict, before: dict, name: str) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items() if k[0] == name}


@pytest.fixture
def _process_defaults():
    """``wire`` configures process-wide layers: restore the defaults."""
    yield
    default = Config.from_dict({"session-store": {"type": "memory"}})
    configure(default.resilience)
    pfetch.configure(default.io)
    pbreaker.BOARD.reset()


async def test_metrics_families_and_counters_match_jax(tmp_path, _process_defaults):
    path = str(tmp_path / "img.ome.tiff")
    write_ome_tiff(path, IMG, tile_size=(64, 64))
    registry = tmp_path / "registry.json"
    registry.write_text(json.dumps({"images": [{"id": 1, "path": path}]}))
    raw = {"session-store": {"type": "memory"}, "image-registry": str(registry),
           "cache": {"prefetch": {"enabled": False}}}
    jax_app = PixelBufferApp(JaxConfig.from_dict(raw),
                             session_store=JaxMemoryStore({"ck": "key1"}))
    jax = TestClient(TestServer(jax_app.make_app()), loop=asyncio.get_running_loop())
    await jax.start_server()
    port = wire(Config.from_dict(raw), session_store=MemorySessionStore({"ck": "key1"}),
                device="cpu")
    port_no = await port.start("127.0.0.1", 0)

    async def port_get(url, headers=None):
        reader, writer = await asyncio.open_connection("127.0.0.1", port_no)
        try:
            head = f"GET {url} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
            for k, v in (headers or {}).items():
                head += f"{k}: {v}\r\n"
            writer.write((head + "\r\n").encode())
            await writer.drain()
            data = await reader.read()
        finally:
            writer.close()
        top, _, body = data.partition(b"\r\n\r\n")
        lines = top.decode("latin-1").split("\r\n")
        return int(lines[0].split()[1]), dict(ln.split(": ", 1) for ln in lines[1:]), body

    async def jax_get(url, headers=None):
        r = await jax.request("GET", url, headers=headers or {})
        return r.status, dict(r.headers), await r.read()

    # the fleet burn gauge registers with a process's first FleetBrains:
    # register both, so the family sets do not hang on which tests ran first
    jbrains._register_fleet_gauge()
    pbrains._register_fleet_gauge()
    try:
        before = [_samples((await get("/metrics"))[2].decode()) for get in (jax_get, port_get)]
        for url in REQUESTS:
            (js, _, jb), (ps, _, pb) = await jax_get(url, COOKIE), await port_get(url, COOKIE)
            assert (ps, pb) == (js, jb), url
        assert (await port_get("/metrics"))[0] == (await jax_get("/metrics"))[0] == 200
        (_, jh, jbody), (_, ph, pbody) = await jax_get("/metrics"), await port_get("/metrics")
        assert ph["Content-Type"] == jh["Content-Type"] == "text/plain; charset=utf-8"
        jax_fams, port_fams = _families(jbody.decode()), _families(pbody.decode())
        assert {k: port_fams[k] for k in PORT_SPAN_FAMILIES} == PORT_SPAN_FAMILIES
        assert jax_fams == {k: v for k, v in port_fams.items() if k not in PORT_SPAN_FAMILIES}
        assert SESSION_PLANE_FAMILIES <= set(port_fams)
        assert MEMBERSHIP_FAMILIES <= set(port_fams)
        after = [_samples(jbody.decode()), _samples(pbody.decode())]
        for name in ("tiles_served_total", "tile_cache_requests_total",
                     "tile_batches_dispatched_total"):
            jd = _delta(after[0], before[0], name)
            pd = _delta(after[1], before[1], name)
            assert {k: v for k, v in pd.items() if v} == {k: v for k, v in jd.items() if v}, name
        hits = ("tile_cache_requests_total", '{outcome="hit",tier="memory"}')
        assert _delta(after[1], before[1], "tile_cache_requests_total")[hits] == 2.0
        om = (await port_get("/metrics", {"Accept": "application/openmetrics-text"}))
        assert om[1]["Content-Type"] == "application/openmetrics-text; charset=utf-8"
        assert om[2].endswith(b"# EOF\n")
        assert _families(om[2].decode())["tiles_served"] == "counter"
    finally:
        await jax.close()
        await port.close()
        port.pipeline.close()
