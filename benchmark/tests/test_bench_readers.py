"""Each per-layer metric reader on canned ``/healthz``, ``/metrics`` and
Chrome-trace snapshots, and the trace's reduction itself."""

import json

import pytest
from conftest import BENCH

from harness import context, manifest
from harness.trace import Trace, clock_offset

METRICS_BEFORE = """# HELP request_stage_seconds x
request_stage_seconds_count{stage="queue_wait"} 10
request_stage_seconds_sum{stage="queue_wait"} 1.0
request_stage_seconds_count{stage="batch_wait"} 100
request_stage_seconds_sum{stage="batch_wait"} 2.0
request_stage_seconds_count{stage="render"} 40
request_stage_seconds_sum{stage="render"} 0.4
http_request_seconds_count{outcome="ok"} 100
http_request_seconds_count{outcome="error"} 2
"""
METRICS_AFTER = """request_stage_seconds_count{stage="queue_wait"} 60
request_stage_seconds_sum{stage="queue_wait"} 4.0
request_stage_seconds_count{stage="batch_wait"} 300
request_stage_seconds_sum{stage="batch_wait"} 6.0
request_stage_seconds_count{stage="render"} 240
request_stage_seconds_sum{stage="render"} 4.4
http_request_seconds_count{outcome="ok"} 298
http_request_seconds_count{outcome="error"} 4
http_request_seconds_bucket{outcome="ok",le="+Inf"} 298
"""
HEALTHZ_BEFORE = {"queue": {"completed": 10, "lanes": 200,
                            "stage_ms_total": {"plan": 1000.0}, "stage_groups": {"plan": 10}},
                  "plane_cache": {"hits": 50, "misses": 10}}
HEALTHZ_AFTER = {"queue": {"completed": 30, "lanes": 840,
                           "stage_ms_total": {"plan": 3600.0}, "stage_groups": {"plan": 30}},
                 "plane_cache": {"hits": 350, "misses": 110}}

# a window of 1,000 us; the filter runs 2 x 10 us, a packer 30 us, a copy 20 us
# overlapping the packer, a memset partly outside the window
TRACE = [
    {"ph": "X", "cat": "kernel", "name": "void filter_row_groups<2, 2>(...)", "ts": 100.0, "dur": 10.0},
    {"ph": "X", "cat": "kernel", "name": "void filter_row_groups_bytes<1, 2>(...)", "ts": 300.0, "dur": 10.0},
    {"ph": "X", "cat": "kernel", "name": "sp_pack_tiles", "ts": 500.0, "dur": 30.0},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 520.0, "dur": 20.0},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 990.0, "dur": 40.0},
    {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 200.0, "dur": 300.0},
    {"ph": "X", "cat": "user_annotation", "name": "bench.open", "ts": 5000.0, "dur": 2.0},
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 10.0},
]
SAMPLES = [(150.0, "ops/device_deflate:_plan"), (160.0, "ops/device_deflate:_plan"),
           (170.0, "http/server:_serve"), (700.0, "models/device_dispatch:_stage")]


def _ctx(trace=None, requests=None, kind="NVIDIA H100 80GB HBM3"):
    return context.Context(
        healthz_before=HEALTHZ_BEFORE, healthz_after=HEALTHZ_AFTER,
        metrics_before=context.parse_prometheus(METRICS_BEFORE),
        metrics_after=context.parse_prometheus(METRICS_AFTER),
        requests=requests if requests is not None else [{"lane": (512, 1024)}] * 4,
        config={}, traffic={}, trace=trace, device_kind=kind, peaks=context.load_peaks())


def _reader(name):
    return manifest.load_module(BENCH / "metrics" / f"{name}.py", f"t_{name}")


def test_trace_reduction():
    t = Trace(TRACE, 0.0, 1000.0, SAMPLES)
    assert t.window_s == pytest.approx(1e-3)
    # union: 10 + 10 + 40 (500..540) + 10 (990..1000) us
    assert t.busy_s == pytest.approx(70e-6)
    assert t.op_seconds("filter_row_groups") == pytest.approx(20e-6)
    assert t.top_ops(2) == [["sp_pack_tiles", pytest.approx(30e-6)],
                            ["Memcpy HtoD", pytest.approx(20e-6)]]
    gaps = t.idle_gaps()
    assert gaps[0] == ["models/device_dispatch:_stage", pytest.approx(450e-6)]  # 540..990
    # 110..300 (host samples of the plan) and 310..500 (none), 190 us each
    assert {g[0] for g in gaps[1:3]} == {"ops/device_deflate:_plan", "no host sample"}
    assert [g[1] for g in gaps[1:3]] == [pytest.approx(190e-6)] * 2
    assert clock_offset({"open": [4.9e-3, 4.9e-3]}, TRACE) == pytest.approx(100.0)


def test_wait_ms_per_request():
    # (3.0 + 4.0) s of waits over 200 requests
    assert _reader("wait_ms_per_request").read(_ctx()) == pytest.approx(35.0)


def test_lanes_per_group():
    assert _reader("lanes_per_group").read(_ctx()) == pytest.approx(32.0)


def test_plan_ms_per_group():
    assert _reader("plan_ms_per_group").read(_ctx()) == pytest.approx(130.0)


def test_plane_miss_pct():
    # 100 misses of 400 lookups in the window
    assert _reader("plane_miss_pct").read(_ctx()) == pytest.approx(25.0)


def test_render_ms_per_request():
    assert _reader("render_ms_per_request").read(_ctx()) == pytest.approx(20.0)


def test_filter_roofline():
    t = Trace(TRACE, 0.0, 1000.0)
    lane = 512 * 1024 + 512 * 1025
    want = 640 * lane / 3.35e12 / 20e-6 * 100
    assert _reader("filter_roofline").read(_ctx(t)) == pytest.approx(want)


def test_device_idle_pct():
    assert _reader("device_idle_pct").read(_ctx(Trace(TRACE, 0.0, 1000.0))) == pytest.approx(93.0)


@pytest.mark.parametrize("name", ["filter_roofline", "device_idle_pct"])
def test_trace_readers_find_nothing_without_a_trace(name):
    assert _reader(name).read(_ctx()) is None


def test_roofline_reads_nothing_on_an_unknown_device_or_no_kernel():
    t = Trace(TRACE, 0.0, 1000.0)
    assert _reader("filter_roofline").read(_ctx(t, kind="cpu")) is None
    no_filter = Trace([e for e in TRACE if "filter" not in e["name"]], 0.0, 1000.0)
    assert _reader("filter_roofline").read(_ctx(no_filter)) is None


def test_counter_readers_find_nothing_without_work():
    ctx = _ctx()
    ctx.healthz_after = ctx.healthz_before
    ctx.metrics_after = ctx.metrics_before
    for name in ("wait_ms_per_request", "lanes_per_group", "plan_ms_per_group",
                 "render_ms_per_request", "plane_miss_pct"):
        assert _reader(name).read(ctx) is None


def test_every_declared_metric_has_a_reader():
    m = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for metric in m["end_to_end"] + m["per_layer"]:
        if metric["name"] != manifest.SETUP:
            assert callable(_reader(metric["name"]).read)


def _served(latencies, statuses, done):
    return [{"status": s, "bytes": 100 * (i + 1), "latency_ms": lat, "done_in_window": d}
            for i, (lat, s, d) in enumerate(zip(latencies, statuses, done))]


def test_client_side_readers():
    ctx = _ctx(requests=_served([10.0, 30.0, 20.0, 60000.0], [200, 200, 200, 0],
                                [True, True, False, True]))
    ctx.window_s = 2.0
    assert _reader("tiles_per_s").read(ctx) == 1.0  # two 200s done inside 2 s
    assert _reader("wire_bytes_per_tile").read(ctx) == 200.0  # (100 + 200 + 300) / 3
    assert _reader("p50_ms").read(ctx) == 20.0  # nearest rank 2 of 4
    ctx.requests = _served([10.0, 60000.0, 60000.0], [200, 0, 0], [True, True, True])
    assert _reader("p50_ms").read(ctx) == 60000.0  # failed requests count as missing
    ctx.requests = []
    for name in ("wire_bytes_per_tile", "p50_ms"):
        assert _reader(name).read(ctx) is None
