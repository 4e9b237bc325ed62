"""The port's gossip membership (``cluster/gossip.py``) against the JAX
package's, on the CPU.

Each case runs one script on a ``GossipManager`` of each package, built
from the same seed, on one fake clock (the managers' monotonic clock and
the ``time`` module both modules read for walls and event stamps), with
canned peers and a dict-backed Redis link. The cases are the JAX suite's
(``tests/test_decentralized.py`` ``TestGossipMerge``,
``TestGossipPiggyback``, ``TestGossipHint``) plus a malformed and an
oversized digest, the 256-entry bound, the drain push, the join hint of a
verified contact and the garbage collection of long-dead members.

Compared after each script: the digest bytes, the member and draining
views, ``snapshot()`` (membership events included), the known entries
and brains, the digests the manager sent, the link's store (sealed
values unsealed) and the ``cluster_gossip_rounds_total`` and
``cluster_membership_events_total`` increments. Tolerance: zero."""

import json

import pytest

from omero_ms_pixel_buffer_tpu.cluster import gossip as jgossip
from omero_ms_pixel_buffer_tpu.cluster import membership as jmembership
from omero_ms_pixel_buffer_tpu.cluster.epochs import EpochRegistry as JaxEpochs
from omero_ms_pixel_buffer_tpu.cluster.security import seal as jseal
from omero_ms_pixel_buffer_tpu.cluster.security import unseal as junseal
from omero_ms_pixel_buffer_tpu_torch.cluster import gossip as pgossip
from omero_ms_pixel_buffer_tpu_torch.cluster import membership as pmembership
from omero_ms_pixel_buffer_tpu_torch.cluster.epochs import EpochRegistry as PortEpochs
from omero_ms_pixel_buffer_tpu_torch.cluster.security import seal as pseal
from omero_ms_pixel_buffer_tpu_torch.cluster.security import unseal as punseal

A, B, C, D = "http://a:1", "http://b:1", "http://c:1", "http://d:1"
PREFIX = "ompb:cluster:member:"
SECRET = "s"


class Clock:
    """One clock for a manager and its module: ``clock()`` is the
    monotonic reading, ``time()`` the wall."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t

    def monotonic(self):
        return self.t


class StubPeers:
    """``PeerClient.gossip``: the digests sent, canned replies per target
    (a callable reply is called)."""

    def __init__(self, replies=None):
        self.replies = replies or {}
        self.sent = []

    async def gossip(self, target, payload):
        self.sent.append((target, payload))
        reply = self.replies.get(target)
        return reply() if callable(reply) else reply


class FakeLink:
    """``RedisLink`` over a dict (SET, MGET, DEL, SCAN); ``dead`` raises."""

    def __init__(self):
        self.store = {}
        self.dead = False

    async def command(self, *parts):
        if self.dead:
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


PACKAGES = {
    "jax": (jgossip, jmembership, JaxEpochs, jseal, junseal),
    "port": (pgossip, pmembership, PortEpochs, pseal, punseal),
}


class Twin:
    """One package's manager and its fakes."""

    def __init__(self, pkg, monkeypatch, self_url=A, seed=(A, B, C), link=False,
                 epochs=False, secret="", **kw):
        self.gossip, self.membership, epochs_cls, self.seal, self.unseal = PACKAGES[pkg]
        self.clock = Clock()
        monkeypatch.setattr(self.gossip, "time", self.clock)
        self.peers = StubPeers()
        self.link = FakeLink() if link else None
        self.epochs = epochs_cls(None) if epochs else None
        self.changes = []
        self.before = self._counts()
        self.gm = self.gossip.GossipManager(
            self.peers, self_url, seed, interval_s=0.1, fanout=2, fail_after_s=1.0,
            clock=self.clock, link=self.link, secret=secret, epochs=self.epochs,
            on_change=lambda added, removed, members: self.changes.append(
                (added, removed, members)), **kw)

    def _counts(self):
        return (dict(self.gossip.GOSSIP_ROUNDS._values),
                dict(self.membership.MEMBERSHIP_EVENTS._values))

    def observed(self) -> dict:
        gm = self.gm
        after = self._counts()
        deltas = [{k: v - before.get(k, 0.0) for k, v in now.items()
                   if v != before.get(k, 0.0)} for before, now in zip(self.before, after)]
        store = None
        if self.link is not None:
            store = {k: self.unseal(SECRET, v) if gm.secret else v
                     for k, v in self.link.store.items()}
        return {
            "digest": gm.digest_bytes(),
            "members": gm.members,
            "draining": gm.draining,
            "snapshot": gm.snapshot(),
            "entries": json.loads(json.dumps(gm._entries)),
            "brains": json.loads(json.dumps(gm._brains)),
            "fleet_brains": gm.fleet_brains(),
            "sent": self.peers.sent,
            "store": store,
            "changes": self.changes,
            "epochs": None if self.epochs is None else self.epochs.snapshot(),
            "counts": deltas,
        }


def member(hb, draining=False, left=False):
    return {"hb": hb, "draining": draining, "left": left}


# -- the scripts ------------------------------------------------------------------------


async def seed_view_is_live(t):
    t.gm._apply_view()


async def higher_heartbeat_wins(t):
    t.gm.merge({"members": {B: member(5, draining=True)}})
    t.gm.merge({"members": {B: member(3)}})  # an older rumour rolls nothing back
    t.gm._apply_view()


async def equal_heartbeat_ors_flags(t):
    t.gm.merge({"members": {B: member(2)}})
    t.gm.merge({"members": {B: member(2, draining=True)}})
    t.gm.merge({"members": {B: member(2)}})
    t.gm._apply_view()


async def stalled_member_expires(t):
    t.clock.t += 2.0
    t.gm._apply_view()


async def advancing_heartbeat_is_liveness(t):
    t.clock.t += 0.9
    t.gm.merge({"members": {B: member(7)}})
    t.clock.t += 0.5
    t.gm._apply_view()


async def tombstone_removes_member(t):
    t.gm.merge({"members": {B: member(9, left=True)}})
    t.gm._apply_view()


async def direct_contact_refutes_tombstone(t):
    t.gm.merge({"members": {B: member(9, left=True)}})
    t.gm._apply_view()
    t.gm.receive({"from": B, "members": {B: member(0)}})


async def self_refutation_outpaces_rumour(t):
    t.gm.merge({"members": {A: member(40, left=True)}})
    t.gm._apply_view()


async def released_self_does_not_refute(t):
    t.gm.released = True
    t.gm._entries[A]["left"] = True
    t.gm.merge({"members": {A: member(40)}})


async def unknown_members_adopted_up_to_256(t):
    t.gm.merge({"members": {f"http://m{i}:1": member(1) for i in range(600)}})
    t.gm._apply_view()


async def malformed_digest_never_raises(t):
    for remote in (None, [], "x", 3, {"members": "nope", "epochs": 3, "brains": []},
                   {"members": {B: "nope", "": member(1), C: {"hb": "x"}, 7: member(1)}},
                   {"members": {B: {"hb": None}, C: {"hb": [1]}}},
                   {"brains": {B: "nope", C: [1, "not-a-dict"], D: [None, {}], A: [9, {}]}},
                   {"epochs": {"x": 1, "2": "y", "3": None}}):
        t.gm.merge(remote)
    t.gm.receive(["not", "a", "dict"])
    t.gm.receive({"from": 5})
    t.gm.receive({"from": "x" * 600})
    t.gm._apply_view()


async def oversized_digest_is_bounded(t):
    t.gm.merge({
        "members": {**{f"http://n{i}:1": member(i) for i in range(1000)},
                    "http://" + "y" * 600: member(1)},
        "epochs": {str(i): i for i in range(2000)},
        "brains": {f"http://n{i}:1": [i, {"pressure": i}] for i in range(1000)},
    })
    t.gm.receive({"from": "http://" + "z" * 600, "members": {}})
    t.gm._apply_view()


async def rotation_covers_all_candidates(t):
    t.gm.fanout = 1
    t.peers.replies = {B: None, C: None}
    for _ in range(4):
        await t.gm.refresh_once()


async def epochs_disseminate(t):
    t.gm.merge({"epochs": {"7": 3, "9": 1}})
    t.epochs.note(7, 5)
    t.gm.merge({"epochs": {"7": 4}})  # high-water only


async def brains_ride_the_digest(t):
    t.gm.set_local_brain({"url": A, "pressure": 0.5, "open": ["pg"]})
    t.gm.merge({"members": {B: member(4)}, "brains": {B: [4, {"pressure": 0.25}]}})


async def stale_brain_never_overwrites(t):
    t.gm.merge({"members": {B: member(5)}, "brains": {B: [5, {"pressure": 0.9}]}})
    t.gm.merge({"brains": {B: [3, {"pressure": 0.1}]}})
    t.gm.merge({"brains": {B: [5, {"pressure": 0.7}]}})  # an equal beat may refresh


async def left_member_brain_excluded(t):
    t.gm.merge({"members": {B: member(5)}, "brains": {B: [5, {"pressure": 0.9}]}})
    t.gm.merge({"members": {B: member(9, left=True)}})
    t.gm._apply_view()


async def release_pushes_tombstone(t):
    t.gm.set_local_brain({"url": A})
    await t.gm.release_lease()
    assert not await t.gm.refresh_once()  # terminal


async def refresh_exchange_merges_reply(t):
    t.peers.replies = {B: {"from": B, "members": {B: member(11), D: member(2)},
                           "brains": {B: [11, {"pressure": 0.3}]}},
                       C: None}
    for _ in range(3):
        t.clock.t += 0.1
        await t.gm.refresh_once()


async def drain_push_marks_draining(t):
    t.peers.replies = {B: {"from": B, "members": {B: member(3)}}, C: None}
    await t.gm.mark_draining()
    t.clock.t += 0.1
    await t.gm.refresh_once()


async def drain_push_reaching_no_peer(t):
    await t.gm.mark_draining()


async def contact_hint_adopts_a_member(t):
    for url in (D, D, A, "", "x" * 600, None):
        t.gm.note_contact(url)


async def gc_forgets_long_dead_members(t):
    t.gm.merge({"members": {D: member(3)}, "brains": {D: [3, {"p": 1}]}})
    t.clock.t += 30.0
    t.peers.replies = {}
    await t.gm.refresh_once()


async def receive_answers_the_digest(t):
    t.gm.set_local_brain({"url": A, "pressure": 0.0})
    reply = t.gm.receive({"from": D, "members": {D: member(1), B: member(2, draining=True)},
                          "epochs": {"1": 2}})
    t.peers.sent.append(("reply", json.dumps(reply, separators=(",", ":"))))


async def hint_adopts_unknown_member(t):
    t.link.store[(PREFIX + D).encode()] = t.seal(SECRET, b'{"url":"http://d:1"}')
    await t.gm._hint_round()
    t.clock.t += 0.1
    await t.gm.refresh_once()


async def hint_rejects_unsealed_lease(t):
    t.link.store[(PREFIX + "http://evil:1").encode()] = b'{"url":"http://evil:1"}'
    await t.gm._hint_round()


async def hint_failure_is_silent(t):
    t.link.dead = True
    await t.gm._hint_round()
    await t.gm.refresh_once()
    await t.gm.release_lease()


SCRIPTS = {
    "seed_view_is_live": (seed_view_is_live, {}),
    "higher_heartbeat_wins": (higher_heartbeat_wins, {}),
    "equal_heartbeat_ors_flags": (equal_heartbeat_ors_flags, {}),
    "stalled_member_expires": (stalled_member_expires, {}),
    "advancing_heartbeat_is_liveness": (advancing_heartbeat_is_liveness, {}),
    "tombstone_removes_member": (tombstone_removes_member, {}),
    "direct_contact_refutes_tombstone": (direct_contact_refutes_tombstone, {}),
    "self_refutation_outpaces_rumour": (self_refutation_outpaces_rumour, {}),
    "released_self_does_not_refute": (released_self_does_not_refute, {}),
    "unknown_members_adopted_up_to_256": (unknown_members_adopted_up_to_256, {}),
    "malformed_digest_never_raises": (malformed_digest_never_raises, {"epochs": True}),
    "oversized_digest_is_bounded": (oversized_digest_is_bounded, {"epochs": True}),
    "rotation_covers_all_candidates": (rotation_covers_all_candidates, {}),
    "epochs_disseminate": (epochs_disseminate, {"epochs": True}),
    "brains_ride_the_digest": (brains_ride_the_digest, {}),
    "stale_brain_never_overwrites": (stale_brain_never_overwrites, {}),
    "left_member_brain_excluded": (left_member_brain_excluded, {}),
    "release_pushes_tombstone": (release_pushes_tombstone, {"link": True}),
    "refresh_exchange_merges_reply": (refresh_exchange_merges_reply, {"epochs": True}),
    "drain_push_marks_draining": (drain_push_marks_draining, {}),
    "drain_push_reaching_no_peer": (drain_push_reaching_no_peer, {}),
    "contact_hint_adopts_a_member": (contact_hint_adopts_a_member, {}),
    "gc_forgets_long_dead_members": (gc_forgets_long_dead_members, {}),
    "receive_answers_the_digest": (receive_answers_the_digest, {"epochs": True}),
    "hint_adopts_unknown_member": (hint_adopts_unknown_member,
                                   {"link": True, "secret": SECRET, "seed": (A,)}),
    "hint_rejects_unsealed_lease": (hint_rejects_unsealed_lease,
                                    {"link": True, "secret": SECRET, "seed": (A,)}),
    "hint_failure_is_silent": (hint_failure_is_silent, {"link": True, "seed": (A, B)}),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
async def test_gossip_manager_matches_jax(name, monkeypatch):
    script, kwargs = SCRIPTS[name]
    seen = {}
    for pkg in ("jax", "port"):
        twin = Twin(pkg, monkeypatch, **kwargs)
        await script(twin)
        seen[pkg] = twin.observed()
    for key in seen["jax"]:
        assert seen["port"][key] == seen["jax"][key], (name, key)


def test_view_facts_of_the_scripts(monkeypatch):
    """A few of the JAX suite's assertions, on the port alone, so the
    comparison above is not between two equal mistakes."""
    import asyncio

    def run(name):
        script, kwargs = SCRIPTS[name]
        twin = Twin("port", monkeypatch, **kwargs)
        asyncio.run(script(twin))
        return twin.gm

    assert run("seed_view_is_live").members == (A, B, C)
    assert run("stalled_member_expires").members == (A,)
    assert run("advancing_heartbeat_is_liveness").members == (A, B)
    assert B not in run("tombstone_removes_member").members
    assert B in run("direct_contact_refutes_tombstone").members
    gm = run("self_refutation_outpaces_rumour")
    assert gm._entries[A] == {"hb": 41, "draining": False, "left": False}
    assert len(run("unknown_members_adopted_up_to_256")._entries) == 256
    assert len(run("oversized_digest_is_bounded")._entries) == 256
    assert run("stale_brain_never_overwrites").fleet_brains()[B]["pressure"] == 0.7
    assert "http://d:1" in run("hint_adopts_unknown_member")._entries
    assert "http://evil:1" not in run("hint_rejects_unsealed_lease")._entries
    assert run("hint_failure_is_silent").hint_failures == 2
    assert D not in run("gc_forgets_long_dead_members")._entries
