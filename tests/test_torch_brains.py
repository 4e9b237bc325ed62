"""The port's fleet brains (``cluster/brains.py``), the breaker's fleet
hint and the scheduler's fleet-pressure hook against the JAX package's,
on the CPU.

Each case runs one script on a ``FleetBrains`` of each package, wired to
that package's scheduler, admission gate, breaker board, quality tracker,
suspicion policy and SLI layer, over a dict-backed Redis link, on one
fake clock (the ``time`` module both brains modules read for the
payload's wall, and the SLI layers' clock). The cases are the JAX suite's
(``tests/test_cluster.py`` ``TestBrains``, ``TestBreakerSuspect`` and the
demotion quorum of ``TestQualityDemotionChaos``) plus sealed and unsigned
brains, the fleet SLI aggregation over malformed brains, the gossip path
(``apply_fleet``) and the local payload under load.

Compared: the published payloads (unsealed), ``snapshot()``, the
scheduler's fleet keys, the suspected breakers' snapshots, the demotions
and the ``on_demote`` calls, the ``slo_burn_rate_fleet`` gauge and the
``cluster_brain_rounds_total`` increments. Tolerance: zero."""

import json

import pytest

from omero_ms_pixel_buffer_tpu.cluster import brains as jbrains
from omero_ms_pixel_buffer_tpu.cluster import suspect as jsuspect
from omero_ms_pixel_buffer_tpu.cluster.security import seal as jseal
from omero_ms_pixel_buffer_tpu.cluster.security import unseal as junseal
from omero_ms_pixel_buffer_tpu.obs.sli import SliLayer as JaxSli
from omero_ms_pixel_buffer_tpu.resilience import breaker as jbreaker
from omero_ms_pixel_buffer_tpu.resilience.admission import AdmissionController as JaxAdmission
from omero_ms_pixel_buffer_tpu.resilience.scheduler import SloScheduler as JaxScheduler
from omero_ms_pixel_buffer_tpu_torch.cluster import brains as pbrains
from omero_ms_pixel_buffer_tpu_torch.cluster import suspect as psuspect
from omero_ms_pixel_buffer_tpu_torch.cluster.security import seal as pseal
from omero_ms_pixel_buffer_tpu_torch.cluster.security import unseal as punseal
from omero_ms_pixel_buffer_tpu_torch.obs.sli import SliLayer as PortSli
from omero_ms_pixel_buffer_tpu_torch.resilience import breaker as pbreaker
from omero_ms_pixel_buffer_tpu_torch.resilience.admission import AdmissionController
from omero_ms_pixel_buffer_tpu_torch.resilience.scheduler import SloScheduler

A, B, C, D = "http://a:80", "http://b:80", "http://c:80", "http://d:80"
SECRET = "brain-secret"

PACKAGES = {
    "jax": (jbrains, jsuspect, jbreaker, JaxScheduler, JaxAdmission, JaxSli, jseal, junseal),
    "port": (pbrains, psuspect, pbreaker, SloScheduler, AdmissionController, PortSli,
             pseal, punseal),
}


@pytest.fixture(autouse=True)
def _boards():
    jbreaker.BOARD.reset()
    pbreaker.BOARD.reset()
    yield
    jbreaker.BOARD.reset()
    pbreaker.BOARD.reset()


class Clock:
    def __init__(self, t=500.0):
        self.t = t

    def __call__(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t


class FakeLink:
    def __init__(self):
        self.store = {}
        self.dead = False

    async def command(self, *parts):
        if self.dead:
            raise ConnectionError("down")
        if parts[0] == b"SET":
            self.store[parts[1]] = (parts[2], parts[4] if len(parts) > 4 else None)
            return b"OK"
        if parts[0] == b"MGET":
            return [self.store.get(k, (None,))[0] for k in parts[1:]]
        raise AssertionError(parts)


class Twin:
    def __init__(self, pkg, monkeypatch, secret="", suspicion=False, quality=False):
        (self.mod, suspect, self.breaker, sched_cls, adm_cls, sli_cls, self.seal,
         self.unseal) = PACKAGES[pkg]
        self.clock = Clock()
        monkeypatch.setattr(self.mod, "time", self.clock)
        self.secret = secret
        self.link = FakeLink()
        self.admission = adm_cls(4)
        self.scheduler = sched_cls(self.admission, queue_size=8)
        self.sli = sli_cls(0.3, clock=self.clock)  # the active layer of its package
        self.quality = suspect.QualityTracker(clock=self.clock) if quality else None
        self.failures = {}
        self.corruptions = {}
        self.demotions = []
        self.before = dict(self.mod.BRAIN_ROUNDS._values)
        self.brains = self.mod.FleetBrains(
            self.link, A, scheduler=self.scheduler, admission=self.admission,
            quality=self.quality,
            suspicion=suspect.SuspicionPolicy(enabled=True, min_requests=4) if suspicion
            else None,
            peer_failures_source=lambda: dict(self.failures),
            on_demote=self.demotions.append, secret=secret,
            corruption_source=lambda: dict(self.corruptions))

    def put_brain(self, url, payload):
        raw = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        self.link.store[b"ompb:cluster:brain:" + url.encode()] = (
            self.seal(self.secret, raw), None)

    def observed(self) -> dict:
        store = {}
        for k, (v, px) in self.link.store.items():
            raw = self.unseal(self.secret, v) if self.secret else v
            try:
                store[k] = (json.loads(raw), px)
            except (TypeError, ValueError):
                store[k] = (raw, px)
        sched = self.scheduler.snapshot()
        after = self.mod.BRAIN_ROUNDS._values
        return {
            "store": store,
            "snapshot": self.brains.snapshot(),
            "fleet": self.scheduler and (sched["fleet_pressure"], sched["fleet_engaged"]),
            "breakers": {k: (v["state"], v["suspect"])
                         for k, v in self.breaker.BOARD.snapshot().items()},
            "demotions": self.demotions,
            "gauge": self.mod._fleet_burn_gauge_values(),
            "pressure_gauge": dict(self.mod.FLEET_PRESSURE._values),
            "rounds": {k: v - self.before.get(k, 0.0) for k, v in after.items()
                       if v != self.before.get(k, 0.0)},
        }


# -- the scripts ------------------------------------------------------------------------


async def publish_collect_round(t):
    assert await t.brains.publish_once(1.0)
    t.put_brain(B, {"url": B, "pressure": 0.0, "open": []})
    assert await t.brains.collect_once([A, B])


async def fleet_pressure_reaches_scheduler(t):
    t.put_brain(B, {"pressure": 1.0, "open": []})
    await t.brains.collect_once([A, B])
    t.result = [t.scheduler.fleet_engaged]
    t.put_brain(B, {"pressure": 0.0, "open": []})
    await t.brains.collect_once([A, B])
    t.result.append(t.scheduler.fleet_engaged)


async def majority_open_dep_suspects_local_breaker(t):
    for url in (B, C):
        t.put_brain(url, {"pressure": 0.0, "open": ["postgres:main"]})
    await t.brains.collect_once([A, B, C])
    breaker = t.breaker.BOARD.create("postgres:main")
    t.result = [breaker.snapshot()["suspect"]]
    breaker.record_failure()  # one local failure trips it
    t.result.append(breaker.state)


async def collect_failure_decays_fleet_state(t):
    t.put_brain(B, {"pressure": 1.0, "open": ["redis:sess"]})
    await t.brains.collect_once([A, B])
    t.link.dead = True
    t.result = [await t.brains.collect_once([A, B]), await t.brains.publish_once(1.0)]


async def two_replica_fleet_single_peer_is_quorum(t):
    t.put_brain(B, {"open": ["redis:sess"]})
    await t.brains.collect_once([A, B])


async def minority_report_does_not_suspect(t):
    t.put_brain(B, {"open": ["redis:sess"]})
    t.put_brain(C, {"open": []})
    t.put_brain(D, {"open": []})
    await t.brains.collect_once([A, B, C, D])


async def suspicion_clears_when_the_fleet_recovers(t):
    for url in (B, C):
        t.put_brain(url, {"open": ["s3:bucket", 7, None]})
    await t.brains.collect_once([A, B, C])
    for url in (B, C):
        t.put_brain(url, {"open": []})
    await t.brains.collect_once([A, B, C])


async def unsigned_and_corrupt_brains_steer_nothing(t):
    t.link.store[b"ompb:cluster:brain:" + B.encode()] = (
        b'{"pressure": 4.0, "open": ["pg"]}', None)
    t.put_brain(C, b"{not json")
    t.put_brain(D, {"pressure": 0.5, "open": []})
    await t.brains.collect_once([A, B, C, D])


async def lonely_replica_collects_nothing(t):
    t.result = [await t.brains.collect_once([A])]


async def fleet_sli_takes_the_worst_replica(t):
    for i in range(20):
        t.sli.record("interactive", 0.01 if i % 3 else 0.9, error=i % 7 == 0)
    t.put_brain(B, {"sli": {"5m": {"interactive": 14.0, "bulk": "x"},
                            "30m": {"prefetch": 2.5}, "1h": "nope", "9h": {"bulk": 99}}})
    t.put_brain(C, {"sli": {"5m": {"interactive": 3.0, "prefetch": None}}})
    t.put_brain(D, {"sli": ["bad"]})
    await t.brains.collect_once([A, B, C, D])


async def local_payload_under_load(t):
    t.admission.try_slot()
    t.admission.try_slot()
    t.admission.try_slot()
    t.scheduler._service_ewma = 0.0421
    t.scheduler.sheds[2] += 3
    t.breaker.BOARD.create("store:s3", failure_threshold=1).record_failure()
    t.breaker.BOARD.create("redis:sess")
    for i in range(10):
        t.sli.record("bulk", 0.5, error=i < 4)
    await t.brains.publish_once(0.5)
    t.result = t.brains.local_payload()  # the shed count was taken: not shedding


async def quality_quorum_demotes_then_restores(t):
    for i in range(12):
        t.quality.note(500 if i < 2 else 200, 0.01 * (i + 1))
    t.failures = {D: 3}
    t.corruptions = {C: 1}
    t.put_brain(B, {"q": {"n": 20, "err": 15, "p99_ms": 5.0}, "bad": [D, C]})
    t.put_brain(C, {"q": {"n": 20, "err": 0, "p99_ms": 400.0}, "bad": [D]})
    t.put_brain(D, {"q": {"n": 20, "err": 0, "p99_ms": 6.0}, "bad": [B]})
    await t.brains.collect_once([A, B, C, D])
    await t.brains.publish_once(1.0)  # carries this round's verdicts
    t.failures, t.corruptions = {}, {}
    for url in (B, C, D):
        t.put_brain(url, {"q": {"n": 20, "err": 0, "p99_ms": 5.0}, "bad": []})
    await t.brains.collect_once([A, B, C, D])


async def gossip_path_applies_the_fleet(t):
    t.brains.apply_fleet({B: {"pressure": 0.95, "open": ["pg"], "bad": [C]},
                          C: {"pressure": 0.9, "open": ["pg"], "q": {"n": 9, "err": 9},
                              "bad": [C]}}, (A, B, C))


async def demotion_never_empties_the_ring(t):
    t.failures = {B: 9}
    t.brains.apply_fleet({B: {"bad": [A, B]}}, (A, B))


SCRIPTS = {
    "publish_collect_round": (publish_collect_round, {}),
    "publish_collect_round_sealed": (publish_collect_round, {"secret": SECRET}),
    "fleet_pressure_reaches_scheduler": (fleet_pressure_reaches_scheduler, {}),
    "majority_open_dep_suspects_local_breaker": (majority_open_dep_suspects_local_breaker, {}),
    "collect_failure_decays_fleet_state": (collect_failure_decays_fleet_state, {}),
    "two_replica_fleet_single_peer_is_quorum": (two_replica_fleet_single_peer_is_quorum, {}),
    "minority_report_does_not_suspect": (minority_report_does_not_suspect, {}),
    "suspicion_clears_when_the_fleet_recovers": (suspicion_clears_when_the_fleet_recovers, {}),
    "unsigned_and_corrupt_brains_steer_nothing": (
        unsigned_and_corrupt_brains_steer_nothing, {"secret": SECRET}),
    "lonely_replica_collects_nothing": (lonely_replica_collects_nothing, {}),
    "fleet_sli_takes_the_worst_replica": (fleet_sli_takes_the_worst_replica, {}),
    "local_payload_under_load": (local_payload_under_load,
                                 {"quality": True, "suspicion": True}),
    "quality_quorum_demotes_then_restores": (quality_quorum_demotes_then_restores,
                                             {"quality": True, "suspicion": True}),
    "gossip_path_applies_the_fleet": (gossip_path_applies_the_fleet, {"suspicion": True}),
    "demotion_never_empties_the_ring": (demotion_never_empties_the_ring, {"suspicion": True}),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
async def test_fleet_brains_match_jax(name, monkeypatch):
    script, kwargs = SCRIPTS[name]
    seen = {}
    for pkg in ("jax", "port"):
        twin = Twin(pkg, monkeypatch, **kwargs)
        twin.result = None
        await script(twin)
        seen[pkg] = {**twin.observed(), "result": twin.result}
        twin.breaker.BOARD.reset()
    for key in seen["jax"]:
        assert seen["port"][key] == seen["jax"][key], (name, key)


async def test_view_facts_of_the_scripts(monkeypatch):
    """The JAX suite's assertions, on the port alone."""
    async def run(name):
        script, kwargs = SCRIPTS[name]
        twin = Twin("port", monkeypatch, **kwargs)
        twin.result = None
        await script(twin)
        return twin

    assert (await run("fleet_pressure_reaches_scheduler")).result == [True, False]
    assert (await run("majority_open_dep_suspects_local_breaker")).result == [True, "open"]
    t = await run("collect_failure_decays_fleet_state")
    assert t.result == [False, False] and not t.scheduler.fleet_engaged
    assert t.brains.suspected == []
    assert (await run("two_replica_fleet_single_peer_is_quorum")).brains.suspected == [
        "redis:sess"]
    assert (await run("minority_report_does_not_suspect")).brains.suspected == []
    t = await run("quality_quorum_demotes_then_restores")
    # D has three bad votes of four reporters; B and C two
    assert t.demotions == [frozenset({D}), frozenset()]
    assert (await run("demotion_never_empties_the_ring")).brains.demoted == [B]
    t = await run("fleet_sli_takes_the_worst_replica")
    # the worst replica per class: this one's own burn (45.0) beats B's 14.0
    assert t.brains.fleet_sli["5m"]["interactive"] == max(
        14.0, t.sli.burn_rates()["5m"]["interactive"])
    assert t.brains.fleet_sli["30m"]["prefetch"] == 2.5


# -- the breaker's fleet hint ---------------------------------------------------------

BREAKER_STEPS = {
    "suspect_trips_on_first_failure": ("suspect", "failure"),
    "success_clears_suspicion": ("suspect", "success", "failure"),
    "clear_suspect": ("suspect", "clear", "failure"),
    "gossip_alone_never_opens": ("suspect",) * 10 + ("allow",),
    "suspect_while_open_is_ignored": ("failure",) * 5 + ("suspect", "wait", "allow",
                                                         "success", "failure"),
    "suspect_survives_until_a_failure": ("failure", "suspect", "failure", "failure"),
}


@pytest.mark.parametrize("name", list(BREAKER_STEPS))
def test_breaker_fleet_hint_matches_jax(name):
    seen = {}
    for pkg, breaker in (("jax", jbreaker), ("port", pbreaker)):
        now = [0.0]
        b = breaker.CircuitBreaker("dep", failure_threshold=5, clock=lambda: now[0])
        trace = []
        for step in BREAKER_STEPS[name]:
            if step == "wait":
                now[0] += 31.0
            elif step == "clear":
                b.clear_suspect()
            elif step in ("suspect", "allow"):
                getattr(b, step)()
            else:
                getattr(b, f"record_{step}")()
            snap = b.snapshot()
            trace.append((step, b.state, snap["suspect"], snap["consecutive_failures"]))
        seen[pkg] = trace
    assert seen["port"] == seen["jax"]
    if name == "suspect_trips_on_first_failure":
        assert seen["port"][-1][1] == "open"
    if name == "gossip_alone_never_opens":
        assert seen["port"][-1][1] == "closed"


def test_null_breaker_takes_the_hint():
    for breaker in (jbreaker, pbreaker):
        breaker.NULL_BREAKER.suspect()
        breaker.NULL_BREAKER.clear_suspect()
        assert breaker.NULL_BREAKER.state == "closed"


@pytest.mark.parametrize("pressure,engaged", [(0.0, False), (0.95, True), (-1.0, False),
                                              (2.5, True)])
async def test_fleet_engaged_opens_the_degrade_check(pressure, engaged):
    """``note_fleet_pressure`` sets the scheduler's fleet keys as JAX's
    does, and an engaged fleet lets an uncontended grant take the degrade
    check."""
    from omero_ms_pixel_buffer_tpu.resilience.deadline import Deadline as JaxDeadline
    from omero_ms_pixel_buffer_tpu_torch.resilience.deadline import Deadline

    seen = []
    for sched_cls, adm_cls, deadline in ((JaxScheduler, JaxAdmission, JaxDeadline),
                                         (SloScheduler, AdmissionController, Deadline)):
        sched = sched_cls(adm_cls(4), queue_size=8)
        sched._service_ewma = 1.0
        sched.note_fleet_pressure(pressure, engaged=engaged)
        snap = sched.snapshot()
        budget = deadline.after(0.5)
        seen.append((snap["fleet_pressure"], snap["fleet_engaged"],
                     sched._degrade_flag(budget, contended=False),
                     sched._degrade_flag(budget, contended=True)))
    assert seen[0] == seen[1]
    assert seen[1][2] is engaged and seen[1][3] is True
