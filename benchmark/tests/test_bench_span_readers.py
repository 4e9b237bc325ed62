"""The seven readers of the port's own spans (hand-off, unclaimed time,
the encode queue's waits, its threads' busy and CPU shares, the groups'
device time) on canned ``/healthz`` and ``/metrics`` snapshots: their
arithmetic, and nothing read where the counters are absent (a program
without them) or the window did no work."""

import pytest
from conftest import BENCH

from harness import context, manifest

METRICS_BEFORE = """request_handoff_seconds_count 40
request_handoff_seconds_sum 0.2
request_unclaimed_seconds_count 100
request_unclaimed_seconds_sum 3.0
http_request_seconds_count{outcome="ok"} 98
http_request_seconds_count{outcome="error"} 2
"""
METRICS_AFTER = """request_handoff_seconds_count 240
request_handoff_seconds_sum 1.2
request_unclaimed_seconds_count 500
request_unclaimed_seconds_sum 23.0
http_request_seconds_count{outcome="ok"} 496
http_request_seconds_count{outcome="error"} 4
"""
WAITS = ("submit_wait", "slot_wait", "readback_wait")
KINDS = ("tiles", "dynamic_pass1", "dynamic_pass2", "render", "mesh")


def _queue(completed, waits_ms, threads, device_ms, device_groups):
    return {"completed": completed,
            "stage_ms_total": dict(zip(WAITS, waits_ms), plan=5.0),
            "stage_groups": dict.fromkeys(WAITS, completed),
            "threads": {t: {"wall_ms": w, "cpu_ms": c} for t, (w, c) in threads.items()},
            "device_ms_total": dict(zip(KINDS, device_ms)), "device_groups": device_groups}


HEALTHZ_BEFORE = {"queue": _queue(10, (100.0, 20.0, 30.0),
                                  {"submit": (1000.0, 900.0), "readback": (2000.0, 1000.0)},
                                  (1.0, 2.0, 3.0, 4.0, 0.0), 10)}
HEALTHZ_AFTER = {"queue": _queue(50, (500.0, 100.0, 230.0),
                                 {"submit": (6000.0, 4900.0), "readback": (12000.0, 5000.0)},
                                 (41.0, 82.0, 43.0, 84.0, 0.0), 50)}


def _ctx(window_s=10.0):
    return context.Context(
        healthz_before=HEALTHZ_BEFORE, healthz_after=HEALTHZ_AFTER,
        metrics_before=context.parse_prometheus(METRICS_BEFORE),
        metrics_after=context.parse_prometheus(METRICS_AFTER),
        requests=[], config={}, traffic={}, window_s=window_s)


def _reader(name):
    return manifest.load_module(BENCH / "metrics" / f"{name}.py", f"t_{name}")


NAMES = ("handoff_ms_per_request", "unclaimed_ms_per_request", "group_wait_ms_per_group",
         "submit_busy_pct", "readback_busy_pct", "encode_cpu_pct", "group_device_ms")


@pytest.mark.parametrize("name,want", [
    ("handoff_ms_per_request", 1.0 / 200 * 1e3),  # 1.0 s over 200 answers
    ("unclaimed_ms_per_request", 20.0 / 400 * 1e3),  # 20 s over 400 completed requests
    ("group_wait_ms_per_group", (400.0 + 80.0 + 200.0) / 40),
    ("submit_busy_pct", 5000.0 / 10e3 * 100),  # 5 s of work in a 10 s window
    ("readback_busy_pct", 10000.0 / 10e3 * 100),
    ("encode_cpu_pct", (4000.0 + 4000.0) / (5000.0 + 10000.0) * 100),
    ("group_device_ms", (40.0 + 80.0 + 40.0 + 80.0) / 40),
])
def test_span_reader_arithmetic(name, want):
    assert _reader(name).read(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_span_readers_find_nothing_without_the_counters(name):
    ctx = _ctx()
    ctx.healthz_before = ctx.healthz_after = {"queue": {"completed": 50, "lanes": 60,
                                                        "stage_ms_total": {"plan": 5.0}}}
    keep = ("http_request_seconds_count",)
    ctx.metrics_before = {k: v for k, v in ctx.metrics_before.items() if k[0] in keep}
    ctx.metrics_after = {k: v for k, v in ctx.metrics_after.items() if k[0] in keep}
    assert _reader(name).read(ctx) is None


@pytest.mark.parametrize("name", NAMES)
def test_span_readers_find_nothing_in_an_idle_window(name):
    ctx = _ctx()
    ctx.healthz_after = ctx.healthz_before
    ctx.metrics_after = ctx.metrics_before
    ctx.window_s = 0.0
    assert _reader(name).read(ctx) is None


def test_span_readers_are_declared_for_both_cells():
    import json

    m = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    declared = {p["name"]: p for p in m["per_layer"]}
    for name in NAMES:
        assert declared[name]["workloads"] == ["plane-png-random", "render-viewport"]
        assert declared[name]["source"] == "program_span"
