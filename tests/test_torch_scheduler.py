"""The port's scheduler plane (``resilience/scheduler.py``, ``admission.py``,
``deadline.py``, ``faultinject.py``, ``utils/loop_watchdog.py`` and the
front's door gate, 503, 504 and ``X-OMPB-Degraded``) against the JAX
package, on the CPU.

- ``SweepDetector``, ``classify``/``header_priority``, ``SloScheduler``
  and ``DeadlineQueue`` run the same seeded call sequences under one
  injected clock (the schedulers' ``time.monotonic`` patched to it):
  equal decisions (grants, degrade flags, queue waits, sheds, expiries,
  cancellations, door previews), equal snapshots, equal pop orders.
- ``Deadline`` and ``TileCtx.to_json``/``from_json`` round trips;
  ``|deg=N`` joins the cache, dedupe and lane keys, priority joins none.
- Fault-injection schedules give the same outcomes call by call.
- The watchdog reports a blocked loop with the JAX snapshot's keys.
- The batcher makes the request's deadline ambient for the batch's
  executor work; a lane past its budget answers 504, counted by stage.
- Both fronts under ``Latency`` schedules at ``render.engine``: the door
  gate's 503 with ``Retry-After`` (a cached tile passes it), 504 on a
  spent budget, and degraded grants answered with the coarse level's
  bytes and ``X-OMPB-Degraded: 1``, equal statuses, headers and bodies,
  and equal ``slo`` counts.

Tolerance: zero."""

import asyncio
import json
import time
import types

import numpy as np
import pytest

import omero_ms_pixel_buffer_tpu.resilience.scheduler as jsched
import omero_ms_pixel_buffer_tpu_torch.resilience.scheduler as psched
from omero_ms_pixel_buffer_tpu.resilience import faultinject as jfi
from omero_ms_pixel_buffer_tpu.resilience.admission import AdmissionController as JaxAdmission
from omero_ms_pixel_buffer_tpu.resilience.deadline import Deadline as JaxDeadline
from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx
from omero_ms_pixel_buffer_tpu.utils.loop_watchdog import LoopWatchdog as JaxWatchdog
from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
from omero_ms_pixel_buffer_tpu_torch.resilience import faultinject as pfi
from omero_ms_pixel_buffer_tpu_torch.resilience.admission import AdmissionController
from omero_ms_pixel_buffer_tpu_torch.resilience.deadline import Deadline
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx
from omero_ms_pixel_buffer_tpu_torch.utils.loop_watchdog import LoopWatchdog

from test_torch_protocols import COOKIE, Fronts


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    """One fake clock for both schedulers' ``time.monotonic``."""
    c = FakeClock()
    fake = types.SimpleNamespace(monotonic=c, perf_counter=time.perf_counter)
    monkeypatch.setattr(psched, "time", fake)
    monkeypatch.setattr(jsched, "time", fake)
    return c


# -- sweep detection and classification ------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_sweep_detector_matches_jax(clock, seed):
    rng = np.random.default_rng(seed)
    threshold, ttl = int(rng.integers(2, 8)), float(rng.uniform(1, 40))
    p = psched.SweepDetector(threshold=threshold, ttl_s=ttl, max_streams=12, clock=clock)
    j = jsched.SweepDetector(threshold=threshold, ttl_s=ttl, max_streams=12, clock=clock)
    pos = {}
    for _ in range(3000):
        session = f"s{int(rng.integers(0, 4))}"
        r = rng.random()
        if r < 0.7:
            image, res = int(rng.integers(0, 2)), [None, 1][int(rng.integers(0, 2))]
            x, y = pos.get((session, image, res), (0, 0))
            w = 0 if rng.random() < 0.1 else 256  # a full-plane request: ignored
            if w and rng.random() < 0.95:  # mostly constant strides
                x += 256
            elif w:
                y += int(rng.choice([0, 256, -256]))
            pos[(session, image, res)] = (x, y)
            args = (session, image, 0, 0, 0, res, x, y, w, 256)
            p.observe(*args)
            j.observe(*args)
        elif r < 0.9:
            assert p.is_sweep(session) == j.is_sweep(session)
        else:
            clock.advance(float(rng.uniform(0, ttl / 3)))
        assert p.snapshot() == j.snapshot()
    assert p.snapshot()["detected_total"] > 0


HEADERS = [{}, {"x-ompb-priority": "bulk"}, {"x-ompb-priority": " Prefetch "},
           {"x-ompb-priority": "vip"}, {"x-ompb-priority": ""},
           {"Sec-Purpose": "prefetch;anonymous-client-ip"}, {"Purpose": "prefetch"},
           {"X-OMPB-Prefetch": "1"}, {"X-OMPB-Prefetch": ""}, {"Purpose": "other"},
           {"x-ompb-priority": "interactive", "Sec-Purpose": "prefetch"}]


def test_classify_matches_jax(clock):
    pd, jd = psched.SweepDetector(threshold=2, clock=clock), jsched.SweepDetector(
        threshold=2, clock=clock)
    for det in (pd, jd):
        for i in range(4):
            det.observe("robot", 1, 0, 0, 0, 0, i * 64, 0, 64, 64)
    for headers in HEADERS:
        lower = {k.lower(): v for k, v in headers.items()}  # as the port's front holds them
        for session in ("robot", "human", None):
            want = jsched.classify(headers, session, jd)
            assert psched.classify(headers, session, pd) == want
            assert psched.classify(lower, session, pd) == want
            assert psched.header_priority(lower) == jsched.header_priority(headers)


# -- the scheduler ----------------------------------------------------------------------


def _state(task):
    if not task.done():
        return "pending"
    if task.cancelled():
        return "cancelled"
    exc = task.exception()
    if exc is not None:
        return (type(exc).__name__, exc.code, getattr(exc, "retry_after_s", None))
    permit = task.result()
    return ("granted", permit.priority, permit.degraded, permit.queued_s)


_SNAP_KEYS = ("enabled", "queue_size", "queued", "classified", "granted", "shed", "degraded",
              "expired_in_queue", "service_ewma_ms", "class_weights", "fleet_pressure",
              "fleet_engaged", "draining")


@pytest.mark.parametrize("seed", range(8))
async def test_slo_scheduler_matches_jax(clock, seed):
    """A seeded sequence of acquires (classes, budgets, degradable),
    releases (trained or not), cancellations, door sheds and clock
    advances on both schedulers in lockstep."""
    rng = np.random.default_rng(seed)
    capacity, queue = int(rng.integers(1, 4)), int(rng.integers(0, 6))
    weights = tuple(int(v) for v in rng.integers(1, 5, 3))
    factor = float(rng.choice([1.5, 4.0]))
    scheds = [
        psched.SloScheduler(AdmissionController(capacity, 2.0), queue_size=queue,
                            class_weights=weights, degrade_factor=factor, clock=clock),
        jsched.SloScheduler(JaxAdmission(capacity, 2.0), queue_size=queue,
                            class_weights=weights, degrade_factor=factor, clock=clock),
    ]
    deadlines = (Deadline, JaxDeadline)
    tasks = []  # [(port task, jax task)]
    released = set()
    for _ in range(160):
        r = rng.random()
        if r < 0.45:
            prio = int(rng.choice([0, 0, 1, 2]))
            budget = None if rng.random() < 0.15 else float(rng.uniform(0.5, 6.0))
            degradable = bool(rng.random() < 0.8)
            tasks.append(tuple(
                asyncio.ensure_future(s.acquire(
                    prio, None if budget is None else d.after(budget, clock=clock),
                    degradable=degradable))
                for s, d in zip(scheds, deadlines)))
        elif r < 0.75:
            granted = [k for k, (pt, _) in enumerate(tasks)
                       if k not in released and pt.done() and not pt.cancelled()
                       and pt.exception() is None]
            if granted:
                k = granted[int(rng.integers(0, len(granted)))]
                train = bool(rng.random() < 0.8)
                released.add(k)
                clock.advance(float(rng.uniform(0, 0.5)))
                for s, t in zip(scheds, tasks[k]):
                    s.release(t.result(), train=train)
        elif r < 0.82:
            pending = [k for k, (pt, _) in enumerate(tasks) if not pt.done()]
            if pending:
                k = pending[int(rng.integers(0, len(pending)))]
                for t in tasks[k]:
                    t.cancel()
        elif r < 0.87:
            prio = int(rng.integers(0, 3))
            for s in scheds:
                s.shed_at_door(prio)
        else:
            clock.advance(float(rng.uniform(0, 2.0)))
        for _ in range(4):
            await asyncio.sleep(0)
        for pt, jt in tasks:
            assert _state(pt) == _state(jt)
        for prio in range(3):
            assert scheds[0].would_overflow_shed(prio) == scheds[1].would_overflow_shed(prio)
        js = scheds[1].snapshot()
        assert scheds[0].snapshot() == {k: js[k] for k in _SNAP_KEYS}
        assert scheds[0].admission.snapshot() == scheds[1].admission.snapshot()
    for pt, jt in tasks:
        for t in (pt, jt):
            t.cancel()
    await asyncio.sleep(0)


def _qitem(cls_ctx, deadline_cls, clock, prio, budget):
    ctx = cls_ctx()
    ctx.priority = prio
    if budget is not None:
        ctx.deadline = deadline_cls.after(budget, clock=clock)
    return (ctx, object())


@pytest.mark.parametrize("seed", range(3))
async def test_deadline_queue_matches_jax(clock, seed):
    rng = np.random.default_rng(seed)
    qs = [psched.DeadlineQueue(maxsize=20), jsched.DeadlineQueue(maxsize=20)]
    ctx_cls = (lambda: TileCtx(1, 0, 0, 0, RegionDef()), lambda: JaxCtx(1, 0, 0, 0, JaxRegion()))
    ids = ({}, {})
    n = 0
    for _ in range(400):
        if rng.random() < 0.55:
            prio = int(rng.integers(0, 3))
            budget = None if rng.random() < 0.1 else float(rng.choice([1.0, 2.0, 5.0]))
            outcomes = []
            for q, mk, d, table in zip(qs, ctx_cls, (Deadline, JaxDeadline), ids):
                item = _qitem(mk, d, clock, prio, budget)
                table[id(item[1])] = n
                try:
                    q.put_nowait(item)
                    outcomes.append("ok")
                except asyncio.QueueFull:
                    outcomes.append("full")
            assert outcomes[0] == outcomes[1]
            n += 1
        elif rng.random() < 0.8:
            got = []
            for q, table in zip(qs, ids):
                try:
                    got.append(table[id(q.get_nowait()[1])])
                except asyncio.QueueEmpty:
                    got.append("empty")
            assert got[0] == got[1]
        else:
            clock.advance(float(rng.uniform(0, 1)))
        assert qs[0].qsize() == qs[1].qsize() and qs[0].empty() == qs[1].empty()
    task = asyncio.ensure_future(qs[0].get())
    while not qs[0].empty():
        qs[0].get_nowait()
    await asyncio.sleep(0)
    item = _qitem(ctx_cls[0], Deadline, clock, 0, None)
    qs[0].put_nowait(item)
    assert await task is item


# -- deadlines, keys, admission, fault injection, watchdog ------------------------------


def test_deadline_matches_jax(clock):
    for budget in (0.0, 0.25, 3.0):
        p, j = Deadline.after(budget, clock=clock), JaxDeadline.after(budget, clock=clock)
        for dt in (0.0, 0.1, 0.2, 5.0):
            clock.advance(dt)
            assert (p.remaining(), p.expired) == (j.remaining(), j.expired)
            for cap in (None, 0.05, 10.0):
                assert p.cap(cap) == j.cap(cap)
            assert p.to_json() == j.to_json()
    assert Deadline.from_json(None) is None and Deadline.from_json({"budgetMs": None}) is None
    again = Deadline.from_json({"budgetMs": 1500.0})
    assert 1.4 < again.remaining() <= 1.5


@pytest.mark.parametrize("degraded,priority", [(0, 0), (1, 2), (2, 1)])
def test_ctx_keys_and_json_match_jax(degraded, priority):
    from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxRender

    q = {"c": "1|0:300$FF0000", "m": "g"}
    p = TileCtx(3, 1, 0, 2, RegionDef(5, 6, 70, 80), resolution=1, format="png",
                omero_session_key="s", render=RenderSpec.from_params(q),
                priority=priority, degraded=degraded)
    j = JaxCtx(3, 1, 0, 2, JaxRegion(5, 6, 70, 80), resolution=1, format="png",
               omero_session_key="s", render=JaxRender.from_params(q),
               priority=priority, degraded=degraded)
    assert p.cache_key("up.6.fast") == j.cache_key("up.6.fast")
    assert p.dedupe_key("up.6.fast") == j.dedupe_key("up.6.fast")
    assert p.lane_key() == j.lane_key()
    want = {k: v for k, v in j.to_json().items() if k != "traceContext"}
    assert p.to_json() == want
    back = TileCtx.from_json(json.loads(json.dumps(p.to_json())))
    assert back.cache_key("q") == p.cache_key("q") and back.priority == priority
    assert TileCtx.from_json(JaxCtx.from_json(j.to_json()).to_json()).lane_key() == p.lane_key()
    other = TileCtx(3, 1, 0, 2, RegionDef(5, 6, 70, 80), resolution=1, format="png",
                    omero_session_key="s", render=RenderSpec.from_params(q))
    assert (other.cache_key() == p.cache_key()) == (degraded == 0)
    with pytest.raises(Exception) as e:
        TileCtx.from_json({"imageId": "x"})
    assert e.value.code == 400 and e.value.message == "Illegal tile context"


def test_admission_matches_jax():
    p, j = AdmissionController(3, 2.0), JaxAdmission(3, 2.0)
    rng = np.random.default_rng(1)
    for _ in range(200):
        op = int(rng.integers(0, 3))
        if op == 0:
            assert p.try_slot() == j.try_slot()
        elif op == 1:
            p.release()
            j.release()
        else:
            p.count_shed()
            j.count_shed()
        assert p.snapshot() == j.snapshot()
        assert (p.inflight, p.shed_total) == (j.inflight, j.shed_total)


def _outcome(o):
    if o is None:
        return None
    if isinstance(o, (pfi.Latency, jfi.Latency)):
        return ("latency", o.seconds)
    exc = o.exc() if callable(o.exc) else o.exc
    return ("fail", type(exc).__name__)


@pytest.mark.parametrize("name,args", [
    ("always", (ValueError,)), ("first_n", (3, KeyError)), ("flap", (2, 3, ValueError)),
    ("latency", (0.25, 3)), ("seeded", (7, 0.3, ValueError)), ("seeded", (8, 0.7, KeyError)),
])
def test_fault_schedules_match_jax(name, args):
    p, j = getattr(pfi, name)(*args), getattr(jfi, name)(*args)
    assert [_outcome(p(n)) for n in range(200)] == [_outcome(j(n)) for n in range(200)]


def test_fault_injector_matches_jax():
    outcomes = []
    for mod in (pfi, jfi):
        inj = mod.FaultInjector()
        seen = []
        inj.install("render.engine", mod.flap(2, 1, ValueError))
        inj.install("store.http", mod.latency(0.0, 2))
        for _ in range(7):
            for point in ("render.engine", "store.http", "device.encode-group"):
                try:
                    inj.fire(point)
                    seen.append("ok")
                except ValueError:
                    seen.append("ValueError")
        seen.append((inj.calls("render.engine"), inj.calls("store.http"),
                     inj.calls("device.encode-group")))
        inj.uninstall("render.engine")
        inj.fire("render.engine")
        inj.clear()
        seen.append(inj.calls("store.http"))
        outcomes.append(seen)
    assert outcomes[0] == outcomes[1]


async def test_latency_on_the_loop_raises_and_fire_async_awaits():
    for mod in (pfi, jfi):
        inj = mod.FaultInjector()
        inj.install("p", mod.latency(0.01))
        with pytest.raises(RuntimeError, match="event-loop thread"):
            inj.fire("p")
        t0 = time.monotonic()
        await inj.fire_async("p")
        assert time.monotonic() - t0 >= 0.009
        inj.install("q", mod.always(KeyError))
        with pytest.raises(KeyError):
            await inj.fire_async("q")


async def test_watchdog_reports_a_blocked_loop():
    """A loop blocked past the threshold is reported (one event), then
    recovers; the snapshot has the JAX watchdog's keys."""
    snaps = []
    for cls in (LoopWatchdog, JaxWatchdog):
        wd = cls(interval_s=0.02, warn_after_s=0.1)
        wd.start()
        try:
            await asyncio.sleep(0.1)
            time.sleep(0.4)  # block the loop
            await asyncio.sleep(0.3)
            snap = wd.snapshot()
        finally:
            wd.stop()
        assert snap["blocked_events"] == 1 and not snap["blocked"]
        assert snap["max_lag_ms"] >= 250.0
        snaps.append(snap)
    assert set(snaps[0]) == set(snaps[1])


# -- the fronts under load ----------------------------------------------------------------

RENDER = "/render/1/0/0/0?c=1|0:40000$FF0000,2|0:30000$00FF00&format=png&w=128&h=128"
TILE = "/tile/1/0/0/0?x=0&y=0&w=64&h=64&format=png"


def _render(x, y):
    return f"{RENDER}&x={x}&y={y}"


async def _scenario(request, steps, scheduler):
    """Run ``steps`` against one front: ("go", key, url, headers) starts a
    request, ("executing", n) and ("queued", n) wait until the front's
    scheduler holds n executing slots or n waiters, ("await", key) waits
    for one answer; returns {key: (status, compared headers, body)}."""
    tasks, out = {}, {}
    for step in steps:
        if step[0] == "go":
            tasks[step[1]] = asyncio.ensure_future(request("GET", step[2], step[3]))
        elif step[0] in ("executing", "queued"):
            t0 = time.monotonic()
            while (scheduler.admission.inflight if step[0] == "executing"
                   else scheduler._waiting_total) < step[1]:
                assert time.monotonic() - t0 < 30, step
                await asyncio.sleep(0.005)
        else:
            out[step[1]] = await tasks.pop(step[1])
    for key, task in tasks.items():
        out[key] = await task
    return {k: (s, {h: v for h, v in hdrs.items()
                    if h in ("retry-after", "x-ompb-degraded", "content-type", "etag",
                             "x-cache", "content-length")}, b)
            for k, (s, hdrs, b) in out.items()}


def _warm_ctxs():
    """Render lanes of the scenarios' spec and sizes for each pipeline,
    outside the result cache: the JAX device programs compile before the
    clock matters."""
    from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxRender

    q = {"c": "1|0:40000$FF0000,2|0:30000$00FF00", "format": "png"}
    port, jax = [], []
    for size in (128, 256):
        port.append([TileCtx(1, 0, 0, 0, RegionDef(0, 256, size, size), format="png",
                             omero_session_key="w", render=RenderSpec.from_params(q))])
        jax.append([JaxCtx(1, 0, 0, 0, JaxRegion(0, 256, size, size), format="png",
                           omero_session_key="w", render=JaxRender.from_params(q))])
    return port, jax


async def _both_scenarios(image_path, steps, latency, config, port_kwargs, factor=None):
    """The same steps on each front in turn, with a ``Latency`` schedule at
    ``render.engine`` (the JAX app on its device engine, where that point
    is); returns (port results, JAX results, the two slo views)."""
    config = {**config, "backend": {"engine": "device"}}
    f = await Fronts(config=config, port_kwargs=port_kwargs).start(image_path)
    try:
        loop = asyncio.get_running_loop()
        for pipeline, batches in zip((f.pipeline, f.jax_app.pipeline), _warm_ctxs()):
            for batch in batches:
                assert isinstance((await loop.run_in_executor(
                    None, pipeline.handle_batch, batch))[0], bytes)
        if factor is not None:
            f.port.scheduler.degrade_factor = factor
        results = []
        for mod, request, sched in ((pfi, f.port_request, f.port.scheduler),
                                    (jfi, f.jax_request, f.jax_app.scheduler)):
            mod.INJECTOR.install("render.engine", mod.latency(latency))
            try:
                results.append(await _scenario(request, steps, sched))
            finally:
                mod.INJECTOR.clear()
        jslo = f.jax_app.scheduler.snapshot()
        return results[0], results[1], f.port.health()["slo"], jslo
    finally:
        await f.close()


async def test_door_shed_and_cache_exemption_match_jax(image_path):
    """One slot and one queue place: the third render arrival sheds at the
    door (503, ``Retry-After: 1``, "Service overloaded"), a bulk-labelled
    one too, a cached tile passes; the occupant and the waiter serve."""
    steps = [("go", "tile", TILE, COOKIE), ("await", "tile"),
             ("go", "occupant", _render(0, 0), COOKIE), ("executing", 1),
             ("go", "waiter", _render(128, 0), COOKIE), ("queued", 1),
             ("go", "shed", _render(256, 0), COOKIE), ("await", "shed"),
             ("go", "bulk", _render(384, 0), {**COOKIE, "X-OMPB-Priority": "bulk"}),
             ("await", "bulk"), ("go", "hit", TILE, COOKIE), ("await", "hit")]
    port, jax, pslo, jslo = await _both_scenarios(
        image_path, steps, 1.5,
        {"resilience": {"admission": {"max-inflight": 1}, "request-budget-ms": 10000},
         "slo": {"queue-size": 1}},
        {"max_inflight": 1, "queue_size": 1, "request_budget_ms": 10000})
    assert port == jax
    assert port["shed"][:1] == (503,) and port["shed"][1]["retry-after"] == "1"
    assert port["shed"][2] == b"Service overloaded"
    assert port["hit"][1]["x-cache"] == "hit"
    assert (port["occupant"][0], port["waiter"][0]) == (200, 200)
    for k in ("classified", "granted", "shed", "expired_in_queue", "degraded"):
        assert pslo[k] == jslo[k], k
    assert pslo["shed"] == {"interactive": 1, "prefetch": 0, "bulk": 1}


async def test_spent_budget_answers_504_like_jax(image_path):
    """A render slower than its budget, and the request queued behind it,
    answer 504 in both fronts."""
    steps = [("go", "first", _render(0, 128), COOKIE), ("executing", 1),
             ("go", "second", _render(128, 128), COOKIE)]
    port, jax, pslo, jslo = await _both_scenarios(
        image_path, steps, 0.7,
        {"resilience": {"admission": {"max-inflight": 1}, "request-budget-ms": 300}},
        {"max_inflight": 1, "request_budget_ms": 300})
    assert port == jax
    assert port["first"] == (504, {"content-length": "0"}, b"")
    assert port["second"][0] == 504


async def test_degraded_grants_match_jax(image_path):
    """After a warm request trains the service-time estimate, requests that
    wait behind an occupant are granted degraded: the next level's pixels
    upscaled, ``X-OMPB-Degraded: 1``, their own ETags; an adapter tile and a
    native one alike. Pressure gone, the same URL serves full resolution."""
    dzi = "/dzi/1_files/10/1_1.png?c=1|0:40000$FF0000,2|0:30000$00FF00"
    steps = [("go", "warm", _render(0, 256), COOKIE), ("await", "warm"),
             ("go", "occupant", _render(128, 256), COOKIE), ("executing", 1),
             ("go", "native", _render(256, 256), COOKIE), ("queued", 1),
             ("go", "dzi", dzi, COOKIE), ("queued", 2), ("await", "native"), ("await", "dzi"),
             ("go", "again", _render(256, 256), COOKIE)]
    port, jax, pslo, jslo = await _both_scenarios(
        image_path, steps, 0.6,
        {"resilience": {"admission": {"max-inflight": 1}, "request-budget-ms": 8000},
         "slo": {"degrade-factor": 40.0}},
        {"max_inflight": 1, "request_budget_ms": 8000}, factor=40.0)
    assert port == jax
    for key in ("native", "dzi"):
        status, hdrs, _ = port[key]
        assert (status, hdrs["x-ompb-degraded"]) == (200, "1"), key
    assert "x-ompb-degraded" not in port["warm"][1] and "x-ompb-degraded" not in port["again"][1]
    assert port["again"][1]["etag"] != port["native"][1]["etag"]
    for k in ("granted", "degraded", "shed"):
        assert pslo[k] == jslo[k], k
    assert pslo["degraded"]["interactive"] == 2


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff

    from test_torch_protocols import IMG

    path = str(tmp_path_factory.mktemp("scheduler") / "img.ome.tiff")
    write_ome_tiff(path, IMG, tile_size=(128, 128), pyramid_levels=3)
    return path


async def test_batch_work_sees_the_request_deadline():
    """The batcher makes the latest lane deadline ambient for the batch's
    executor work (what ``retry_call`` and the fetch planner read), and a
    lane already past its budget answers 504, counted at ``admission``."""
    from omero_ms_pixel_buffer_tpu_torch.dispatch.batcher import BatchingTileWorker
    from omero_ms_pixel_buffer_tpu_torch.errors import GatewayTimeoutError
    from omero_ms_pixel_buffer_tpu_torch.resilience import deadline as pdeadline

    seen = []

    class Probe:
        def handle(self, ctx):
            seen.append(pdeadline.current_deadline())
            return b"tile"

    worker = BatchingTileWorker(Probe())
    await worker.start()
    try:
        ctx = TileCtx(1, 0, 0, 0, RegionDef(0, 0, 8, 8), format="png")
        ctx.deadline = Deadline.after(5.0)
        assert await worker.handle(ctx) == (b"tile", {"filename": ctx.filename()})
        assert seen == [ctx.deadline] and pdeadline.current_deadline() is None
        late = TileCtx(1, 0, 0, 0, RegionDef(0, 0, 8, 8), format="png")
        late.deadline = Deadline.after(0.0)
        before = pdeadline.snapshot().get("admission", 0)
        with pytest.raises(GatewayTimeoutError):
            await worker.handle(late)
        assert pdeadline.snapshot()["admission"] == before + 1
    finally:
        await worker.close()
