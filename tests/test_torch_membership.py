"""The port's lease membership (``cluster/membership.py``) against the JAX
package's, on the CPU.

Each case runs one script on a fleet of ``MembershipManager``s of each
package over one dict-backed Redis link (SET with PX, SCAN, MGET, DEL),
on one fake clock: the managers' monotonic clock and the ``time`` module
the package reads for lease walls and event stamps. Lease expiry is a
deleted key. The cases are the JAX suite's (``tests/test_cluster.py``
``TestMembership`` and the lease half of ``TestMembershipChurn``) plus
sealed, unsigned, tampered and corrupt leases, the draining marker, its
publish failure, the release and its failure. One case runs both
packages' own ``RedisLink`` against the port's RESP stub.

Compared: each manager's members, draining set and ``snapshot()``
(events included), the ``on_change`` calls, the commands sent, the
store with every lease unsealed, and the ``cluster_membership_events_total``
increments. Tolerance: zero."""

import json

import pytest

from omero_ms_pixel_buffer_tpu.cluster import membership as jmembership
from omero_ms_pixel_buffer_tpu.cluster.link import RedisLink as JaxLink
from omero_ms_pixel_buffer_tpu.cluster.security import seal as jseal
from omero_ms_pixel_buffer_tpu.cluster.security import unseal as junseal
from omero_ms_pixel_buffer_tpu_torch.cache.plane.resp_stub import InMemoryRespServer
from omero_ms_pixel_buffer_tpu_torch.cluster import membership as pmembership
from omero_ms_pixel_buffer_tpu_torch.cluster.link import RedisLink as PortLink
from omero_ms_pixel_buffer_tpu_torch.cluster.security import seal as pseal
from omero_ms_pixel_buffer_tpu_torch.cluster.security import unseal as punseal

URLS = ["http://r0:80", "http://r1:80", "http://r2:80"]
PREFIX = b"ompb:cluster:member:"
SECRET = "lease-secret"

PACKAGES = {"jax": (jmembership, jseal, junseal, JaxLink),
            "port": (pmembership, pseal, punseal, PortLink)}


class Clock:
    def __init__(self, t=50.0):
        self.t = t

    def __call__(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t

    def monotonic(self):
        return self.t


class FakeLink:
    """A dict Redis shared by a fleet's managers; ``dead`` raises, and
    ``fail`` names the one command that raises."""

    def __init__(self):
        self.store = {}
        self.sent = []
        self.dead = False
        self.fail = None

    async def command(self, *parts):
        self.sent.append(parts[:1] + parts[1:2] + parts[3:])  # values vary with the seal
        if self.dead or parts[0] == self.fail:
            raise ConnectionError("down")
        if parts[0] == b"SET":
            self.store[parts[1]] = parts[2]
            return b"OK"
        if parts[0] == b"MGET":
            return [self.store.get(k) for k in parts[1:]]
        if parts[0] == b"DEL":
            return int(self.store.pop(parts[1], None) is not None)
        raise AssertionError(parts)

    async def scan_keys(self, pattern):
        if self.dead:
            raise ConnectionError("down")
        return sorted(self.store)


class Fleet:
    """Managers of one package over one link and one clock."""

    def __init__(self, pkg, monkeypatch, n=3, ttl=3.0, secret="", seeds=None):
        self.mod, self.seal, self.unseal, _ = PACKAGES[pkg]
        self.clock = Clock()
        monkeypatch.setattr(self.mod, "time", self.clock)
        self.link = FakeLink()
        self.secret = secret
        self.changes = [[] for _ in range(n)]
        self.before = dict(self.mod.MEMBERSHIP_EVENTS._values)
        self.m = [
            self.mod.MembershipManager(
                self.link, URLS[i], seeds[i] if seeds else [URLS[i]], ttl,
                on_change=lambda a, r, mem, i=i: self.changes[i].append((a, r, mem)),
                clock=self.clock, secret=secret)
            for i in range(n)]

    async def round(self, *which):
        return [await self.m[i].refresh_once() for i in (which or range(len(self.m)))]

    def observed(self) -> dict:
        after = self.mod.MEMBERSHIP_EVENTS._values
        store = {}
        for k, v in self.link.store.items():
            raw = self.unseal(self.secret, v) if self.secret else v
            try:
                store[k] = json.loads(raw)
            except (TypeError, ValueError):
                store[k] = raw
        return {
            "members": [m.members for m in self.m],
            "draining": [m.draining for m in self.m],
            "snapshots": [m.snapshot() for m in self.m],
            "changes": self.changes,
            "sent": self.link.sent,
            "store": store,
            "events": {k: v - self.before.get(k, 0.0) for k, v in after.items()
                       if v != self.before.get(k, 0.0)},
        }


# -- the scripts ------------------------------------------------------------------------


async def leases_discover_each_other(f):
    f.results = [await f.round(), await f.round()]


async def lease_expiry_removes_member(f):
    await f.round()
    await f.round()
    f.clock.t += 4.0
    del f.link.store[PREFIX + URLS[1].encode()]  # r1 stopped: its PX ran out
    f.results = await f.round(0, 2)


async def redis_down_keeps_last_known_view(f):
    await f.round()
    await f.round()
    f.link.dead = True
    f.clock.t += 1.0
    f.results = await f.round()


async def seeded_view_until_the_first_scan(f):
    f.link.dead = True
    f.results = await f.round()


async def draining_marker_in_the_payload(f):
    await f.round()
    f.link.store[PREFIX + URLS[1].encode()] = f.seal(
        f.secret, b'{"url":"http://r1:80","wall":1.0,"draining":true}')
    f.results = await f.round(0, 2)


async def corrupt_payload_is_a_plain_lease(f):
    await f.round()
    f.link.store[PREFIX + b"http://odd:1"] = f.seal(f.secret, b"{not json")
    f.link.store[PREFIX + b"http://list:1"] = f.seal(f.secret, b"[1, 2]")
    f.results = await f.round(0)


async def unsigned_and_tampered_leases_grant_nothing(f):
    await f.round()
    f.link.store[PREFIX + b"http://evil:1"] = b'{"url":"http://evil:1"}'
    sealed = bytearray(f.seal(f.secret, b'{"url":"http://bad:1"}'))
    sealed[-1] ^= 1
    f.link.store[PREFIX + b"http://bad:1"] = bytes(sealed)
    f.link.store[PREFIX + b"http://gone:1"] = None  # expired between SCAN and MGET
    f.results = await f.round(0)


async def mark_draining_publishes_now(f):
    await f.round()
    await f.round()
    f.results = [await f.m[1].mark_draining()]
    f.clock.t += 1.0
    f.results.append(await f.round())


async def drain_publish_failure(f):
    await f.round()
    f.link.fail = b"SET"
    f.results = [await f.m[0].mark_draining()]


async def release_deletes_the_lease(f):
    await f.round()
    await f.round()
    await f.m[1].mark_draining()
    f.results = [await f.m[1].release_lease()]
    f.clock.t += 1.0
    f.results.append(await f.round())  # terminal for r1; the others see the leave


async def release_failure_expires_by_ttl(f):
    await f.round()
    f.link.fail = b"DEL"
    f.results = [await f.m[2].release_lease()]


async def on_change_hook_failure_is_contained(f):
    f.m[0].on_change = lambda *a: 1 / 0
    f.results = [await f.round(), await f.round()]


SCRIPTS = {
    "leases_discover_each_other": (leases_discover_each_other, {}),
    "leases_discover_each_other_sealed": (leases_discover_each_other, {"secret": SECRET}),
    "lease_expiry_removes_member": (lease_expiry_removes_member, {}),
    "redis_down_keeps_last_known_view": (
        redis_down_keeps_last_known_view, {"seeds": [URLS[:2], URLS[:2], URLS]}),
    "seeded_view_until_the_first_scan": (
        seeded_view_until_the_first_scan, {"seeds": [URLS, [URLS[1]], URLS[1:]]}),
    "draining_marker_in_the_payload": (draining_marker_in_the_payload, {"secret": SECRET}),
    "corrupt_payload_is_a_plain_lease": (corrupt_payload_is_a_plain_lease, {}),
    "unsigned_and_tampered_leases_grant_nothing": (
        unsigned_and_tampered_leases_grant_nothing, {"secret": SECRET}),
    "mark_draining_publishes_now": (mark_draining_publishes_now, {"secret": SECRET}),
    "drain_publish_failure": (drain_publish_failure, {}),
    "release_deletes_the_lease": (release_deletes_the_lease, {}),
    "release_failure_expires_by_ttl": (release_failure_expires_by_ttl, {}),
    "on_change_hook_failure_is_contained": (on_change_hook_failure_is_contained, {}),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
async def test_membership_manager_matches_jax(name, monkeypatch):
    script, kwargs = SCRIPTS[name]
    seen = {}
    for pkg in ("jax", "port"):
        fleet = Fleet(pkg, monkeypatch, **kwargs)
        await script(fleet)
        seen[pkg] = {**fleet.observed(), "results": fleet.results}
    for key in seen["jax"]:
        assert seen["port"][key] == seen["jax"][key], (name, key)


async def test_view_facts_of_the_scripts(monkeypatch):
    """The JAX suite's assertions, on the port alone."""
    async def run(name):
        script, kwargs = SCRIPTS[name]
        fleet = Fleet("port", monkeypatch, **kwargs)
        await script(fleet)
        return fleet

    f = await run("leases_discover_each_other")
    assert all(list(m.members) == URLS and not m.seeded for m in f.m)
    f = await run("lease_expiry_removes_member")
    assert URLS[1] not in f.m[0].members
    assert [e["event"] for e in f.m[0].events] == ["join", "join", "leave"]
    f = await run("redis_down_keeps_last_known_view")
    assert f.results == [False, False, False] and f.m[0].members == tuple(URLS)
    assert f.m[0].refresh_failures == 1
    f = await run("draining_marker_in_the_payload")
    assert f.m[0].draining == frozenset({URLS[1]}) and URLS[1] in f.m[0].members
    f = await run("unsigned_and_tampered_leases_grant_nothing")
    assert f.m[0].members == tuple(URLS)
    f = await run("release_deletes_the_lease")
    assert f.results[0] is True and URLS[1] not in f.m[0].members
    assert f.m[1].released and f.results[1][1] is False


async def test_leases_over_each_packages_link_and_the_stub(monkeypatch):
    """Both packages' ``RedisLink`` against the port's RESP stub: three
    managers each, leases discovered in two rounds, the same members and
    the same unsealed payloads."""
    seen = {}
    for pkg, (mod, _seal, unseal, link_cls) in PACKAGES.items():
        clock = Clock()
        monkeypatch.setattr(mod, "time", clock)
        stub = InMemoryRespServer()
        await stub.start()
        links = [link_cls(stub.uri) for _ in URLS]
        managers = [mod.MembershipManager(links[i], URLS[i], [URLS[i]], 5.0, clock=clock,
                                          secret=SECRET) for i in range(3)]
        try:
            for _ in range(2):
                for m in managers:
                    assert await m.refresh_once()
            seen[pkg] = ([m.members for m in managers],
                         {k: json.loads(unseal(SECRET, v[0])) for k, v in stub.data.items()},
                         [m.snapshot() for m in managers])
        finally:
            for link in links:
                await link.close()
            await stub.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [tuple(URLS)] * 3
