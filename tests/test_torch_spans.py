"""The port's own spans: the encode queue's three waits and its two
threads' work clocks in ``DeviceEncodeDispatcher.snapshot()``; the
batcher's ``request_handoff_seconds`` (one observation per answered lane,
deferred lanes and deduplicated followers included); the recorder's
``request_unclaimed_seconds`` (total minus the stages, under a fake
clock); the ``ompb.*`` profiler ranges, entered only while a profiler
runs and present in its exported trace. The ``cuda``-marked test checks
each kind of group's device span from CUDA events (it skips without a
card). No JAX import, so the file runs where only PyTorch is installed.
Inputs: ``numpy.random.default_rng(23)``."""

import asyncio
import concurrent.futures
import json
import threading
import time

import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu_torch.dispatch.batcher import BatchingTileWorker
from omero_ms_pixel_buffer_tpu_torch.models import device_dispatch as dd
from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import DeferredTile
from omero_ms_pixel_buffer_tpu_torch.obs import recorder as prec
from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

rng = np.random.default_rng(23)
ROWS, COLS = 24, 40
TILES = rng.integers(0, 4096, (3, ROWS, COLS), dtype=np.uint16)
WAITS = ("submit_wait", "slot_wait", "readback_wait")


def _submit(q, mode, lanes=3):
    return q.submit(bits_tensor(TILES[:lanes]), ROWS, 1 + 2 * COLS, 2, "up", mode,
                    list(range(lanes)), [(COLS, ROWS)] * lanes, 16, 0)


def _count(hist, **labels) -> int:
    return sum(hist._counts.get(tuple(sorted(labels.items())), []))


def _sum(hist, **labels) -> float:
    return hist._sums.get(tuple(sorted(labels.items())), 0.0)


@pytest.mark.parametrize("mode", ["dynamic", "rle"])
def test_queue_reports_waits_and_thread_clocks(mode):
    q = dd.DeviceEncodeDispatcher(torch.device("cpu"), queue_depth=1)
    try:
        futs = [_submit(q, mode) for _ in range(4)]
        for f in futs:
            assert sorted(f.result(60)) == [0, 1, 2]
        snap = q.snapshot()
    finally:
        q.close()
    # the groups queued behind the submit thread merge: ``completed``
    # counts device groups, ``merged`` the groups that rode in another's
    assert snap["groups"] == 4 and snap["failed"] == 0
    assert snap["completed"] + snap["merged"] == 4 and snap["lanes"] == 12
    for stage, n in snap["stage_groups"].items():
        assert n == snap["completed"], stage
    for w in WAITS:
        assert snap["stage_ms_total"][w] >= 0.0
    assert set(snap["threads"]) == {"submit", "readback"}
    for name, t in snap["threads"].items():
        assert t["wall_ms"] >= t["cpu_ms"] >= 0.0, name
        assert t["wall_ms"] > 0.0, name
    # no CUDA events on the CPU: every kind stays at 0, no group timed
    assert snap["device_ms_total"] == dict.fromkeys(dd.DEVICE_KINDS, 0.0)
    assert snap["device_groups"] == 0


def test_slot_wait_is_not_thread_work():
    """A group held at the in-flight slot shows in ``slot_wait``, not in the
    submit thread's work."""
    q = dd.DeviceEncodeDispatcher(torch.device("cpu"), queue_depth=1)
    try:
        q._slots.acquire()  # the only slot, held for 0.3 s
        fut = _submit(q, "rle")
        time.sleep(0.3)
        q._slots.release()
        fut.result(60)
        snap = q.snapshot()
    finally:
        q.close()
    assert snap["stage_ms_total"]["slot_wait"] >= 250.0
    assert snap["threads"]["submit"]["wall_ms"] < 250.0


class _Pipeline:
    """``handle_batch`` answers lane 0 at once and defers the others: lane
    1's group resolves on another thread after the batch returns, lane 2's
    before it."""

    def __init__(self):
        self.batches = []

    def handle(self, ctx):
        return b"lone"

    def handle_batch(self, ctxs, defer=False):
        self.batches.append(len(ctxs))
        out = []
        for i, _ in enumerate(ctxs):
            if i == 0:
                out.append(b"now")
                continue
            fut = concurrent.futures.Future()
            if i == 1:
                threading.Timer(0.05, fut.set_result, (b"later",)).start()
            else:
                fut.set_result(b"done")
            out.append(DeferredTile(fut))
        return out


def _ctx(x, rec):
    return TileCtx(image_id=1, z=0, c=0, t=0, region=RegionDef(x, 0, 64, 64), format="png",
                   obs=rec)


async def test_handoff_counts_every_answered_lane():
    pipeline = _Pipeline()
    worker = BatchingTileWorker(pipeline, supertile=False, coalesce_window_ms=20.0)
    await worker.start()
    before = _count(prec.REQUEST_HANDOFF_SECONDS)
    try:
        recs = [prec.FlightRecord("/tile") for _ in range(4)]
        # lanes at x = 0, 64, 128 and a follower of the deferred x = 64
        xs = (0, 64, 128, 64)
        answers = await asyncio.gather(*(worker.handle(_ctx(x, r)) for x, r in zip(xs, recs)))
        assert [a[0] for a in answers] == [b"now", b"later", b"done", b"later"]
        lone_rec = prec.FlightRecord("/tile")
        assert (await worker.handle(_ctx(0, lone_rec)))[0] == b"lone"
    finally:
        await worker.close()
    assert pipeline.batches == [3]
    assert _count(prec.REQUEST_HANDOFF_SECONDS) - before == 5
    for rec in recs + [lone_rec]:
        assert rec.ready_at is not None and rec.ready_at <= time.perf_counter()
    # the group that resolved late stamped its lanes after the batch's
    assert recs[1].ready_at == recs[3].ready_at > recs[0].ready_at == recs[2].ready_at


class _FakeClock:
    def __init__(self):
        self.now = 500.0

    def perf_counter(self) -> float:
        return self.now

    monotonic = perf_counter

    def time(self) -> float:
        return 1.7e9 + self.now


def test_unclaimed_is_total_minus_the_stages(monkeypatch):
    clock = _FakeClock()
    monkeypatch.setattr(prec, "time", clock)
    recorder = prec.FlightRecorder(head_sample_rate=1.0)
    n0, s0 = _count(prec.REQUEST_UNCLAIMED_SECONDS), _sum(prec.REQUEST_UNCLAIMED_SECONDS)
    want = []
    for k in range(12):
        rec = recorder.start("/tile/1/0/0/0")
        stamped = 0.0
        for _ in range(int(rng.integers(0, 5))):
            stage = prec.STAGES[int(rng.integers(0, len(prec.STAGES)))]
            dur = float(rng.exponential(0.01))
            clock.now += dur
            rec.stamp(stage, dur)
            stamped += dur
        # every third record has nested stamps that exceed its total: 0
        clock.now += -stamped / 2 if k % 3 == 2 else float(rng.exponential(0.02))
        recorder.complete(rec, 200)
        want.append(max(0.0, rec.total - stamped))
        assert rec.wide_event()["unattributed_ms"] == pytest.approx(want[-1] * 1e3, abs=1e-3)
    assert _count(prec.REQUEST_UNCLAIMED_SECONDS) - n0 == 12
    assert _sum(prec.REQUEST_UNCLAIMED_SECONDS) - s0 == pytest.approx(sum(want))


def _exercise(q):
    """A stage timer, a batched stage, and a dynamic and a one-pass group
    under one flight record."""
    rec = prec.FlightRecord("/tile")
    ctx = _ctx(0, rec)
    with rec.stage("resolve"):
        pass
    with prec.stage_all([ctx], "read"):
        pass
    with prec.record_scope(rec):
        futs = [_submit(q, "dynamic"), _submit(q, "rle")]
    for f in futs:
        f.result(60)
    return rec


def test_no_range_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, *args, **kwargs):
            entered.append(args)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    q = dd.DeviceEncodeDispatcher(torch.device("cpu"))
    try:
        _exercise(q)
    finally:
        q.close()
    assert entered == []


def _range_names(path) -> set:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("name", "").startswith("ompb.")}


def test_ranges_land_in_the_trace_of_every_thread(tmp_path):
    from torch._C._profiler import _ExperimentalConfig

    q = dd.DeviceEncodeDispatcher(torch.device("cpu"))
    try:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        prof.start()
        try:
            rec = _exercise(q)
        finally:
            prof.stop()
        prof.export_chrome_trace(str(tmp_path / "trace.json"))
    finally:
        q.close()
    names = _range_names(tmp_path / "trace.json")
    tid = rec.trace_id
    want = ["resolve", "read"] + [f"queue.{n}" for n in (
        "submit_wait", "slot_wait", "stage", "readback_wait", "pass1_wait", "plan", "pass2",
        "compute", "pull", "frame")] + ["prog.pass1", "prog.pass2", "prog.one_pass"]
    assert {f"ompb.{n}@{tid}" for n in want} <= names


def test_ranges_of_the_profiling_thread_under_default_settings(tmp_path):
    rec = prec.FlightRecord("/tile")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.stage("auth"):
            pass
        with prec.profiler_range("prog.histogram"):
            pass
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    assert {f"ompb.auth@{rec.trace_id}", "ompb.prog.histogram"} <= _range_names(
        tmp_path / "trace.json")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_device_span_by_group_kind(cuda_device):
    from omero_ms_pixel_buffer_tpu_torch.parallel.mesh import MeshManager, make_mesh
    from omero_ms_pixel_buffer_tpu_torch.render.engine import build_tables
    from omero_ms_pixel_buffer_tpu_torch.render.luts import LutRegistry
    from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec

    tables, luts = build_tables(RenderSpec.from_params({"c": "1|0:4095$FF0000,2$00FF00"}),
                                np.dtype(np.uint16), LutRegistry())
    planes = bits_tensor(rng.integers(0, 4096, (3, 2, ROWS, COLS), dtype=np.uint16))

    def render(q):
        return q.submit_render(planes, tables, luts, ROWS, 1 + 3 * COLS, "up", "rle",
                               [0, 1, 2], [(COLS, ROWS)] * 3)

    cases = [("tiles", lambda q: _submit(q, "rle"), None),
             ("dynamic_pass1", lambda q: _submit(q, "dynamic"), None),
             ("render", render, None),
             ("mesh", lambda q: _submit(q, "rle"), [cuda_device, cuda_device])]
    for kind, submit, slots in cases:
        q = dd.DeviceEncodeDispatcher(cuda_device)
        try:
            if slots is not None:
                q.set_mesh_manager(MeshManager(make_mesh(slots)))
            for _ in range(2):  # built and warm
                submit(q).result(300)
            before = q.snapshot()
            t0 = time.perf_counter()
            submit(q).result(300)
            wall_ms = (time.perf_counter() - t0) * 1e3
            after = q.snapshot()
        finally:
            q.close()
        assert after["device_groups"] - before["device_groups"] == 1, kind
        grew = {k: after["device_ms_total"][k] - before["device_ms_total"][k]
                for k in dd.DEVICE_KINDS}
        kinds = {"dynamic_pass1", "dynamic_pass2"} if kind == "dynamic_pass1" else {kind}
        assert {k for k, v in grew.items() if v > 0} == kinds, (kind, grew)
        assert 0 < sum(grew.values()) <= wall_ms, (kind, grew, wall_ms)
