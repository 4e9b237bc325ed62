"""The static fleet's building blocks against their JAX counterparts, on
inputs made from a seed with numpy: ``HashRing.owner``/``owners``,
``sign``/``verify``/``seal``/``unseal`` and the nonce cache, the L2 frame
(``encode_entry``/``decode_entry_epoch``, both modules' ``time`` on one
fake clock), the transfer framing, the anti-entropy digest and its
diff, the epoch registry, the corruption ledger, the replicator's
choices, ``HedgePolicy``'s delay and the quality tracker and suspicion
policy. Tolerance: zero (equal values, equal bytes)."""

import asyncio

import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu.cache.plane import l2 as jl2
from omero_ms_pixel_buffer_tpu.cache.plane.ring import HashRing as JaxRing
from omero_ms_pixel_buffer_tpu.cache.result_cache import CachedTile as JaxTile
from omero_ms_pixel_buffer_tpu.cluster import epochs as jepochs
from omero_ms_pixel_buffer_tpu.cluster import hedge as jhedge
from omero_ms_pixel_buffer_tpu.cluster import integrity as jintegrity
from omero_ms_pixel_buffer_tpu.cluster import repair as jrepair
from omero_ms_pixel_buffer_tpu.cluster import replicate as jreplicate
from omero_ms_pixel_buffer_tpu.cluster import security as jsec
from omero_ms_pixel_buffer_tpu.cluster import suspect as jsuspect
from omero_ms_pixel_buffer_tpu_torch.cache.plane import l2 as pl2
from omero_ms_pixel_buffer_tpu_torch.cache.plane.ring import HashRing as PortRing
from omero_ms_pixel_buffer_tpu_torch.cache.result_cache import CachedTile as PortTile
from omero_ms_pixel_buffer_tpu_torch.cluster import epochs as pepochs
from omero_ms_pixel_buffer_tpu_torch.cluster import hedge as phedge
from omero_ms_pixel_buffer_tpu_torch.cluster import integrity as pintegrity
from omero_ms_pixel_buffer_tpu_torch.cluster import repair as prepair
from omero_ms_pixel_buffer_tpu_torch.cluster import replicate as preplicate
from omero_ms_pixel_buffer_tpu_torch.cluster import security as psec
from omero_ms_pixel_buffer_tpu_torch.cluster import suspect as psuspect

SEEDS = range(4)


def _members(rng, n=None):
    n = int(rng.integers(1, 7)) if n is None else n
    ports = rng.choice(np.arange(8000, 9000), size=n, replace=False)
    return [f"http://10.0.0.{int(rng.integers(1, 250))}:{int(p)}" for p in ports]


def _keys(rng, n=64):
    return [f"img={int(rng.integers(1, 50))}|z=0|c=0|t=0|res=0|x={int(rng.integers(0, 8192))}"
            f"|y={int(rng.integers(0, 8192))}|w=512|h=512|fmt=png|q=dyn" for _ in range(n)]


@pytest.mark.parametrize("seed", SEEDS)
def test_ring_owner_and_owners_match_jax(seed):
    rng = np.random.default_rng(seed)
    members = _members(rng)
    vnodes = int(rng.integers(1, 128))
    jr, pr = JaxRing(members, vnodes), PortRing(members, vnodes)
    assert pr.snapshot() == jr.snapshot()
    for key in _keys(rng):
        assert pr.owner(key) == jr.owner(key)
        for n in (1, 2, 3, len(members) + 1):
            assert pr.owners(key, n) == jr.owners(key, n)
    for bad in ([], ["http://a:1", "http://a:1"]):
        with pytest.raises(ValueError):
            PortRing(bad)


@pytest.mark.parametrize("seed", SEEDS)
def test_sign_verify_seal_match_jax(seed):
    rng = np.random.default_rng(seed)
    secret = rng.bytes(12).hex()
    body = rng.bytes(int(rng.integers(0, 300)))
    now = 1.7e9 + float(rng.integers(0, 10**6))
    nonce = rng.bytes(8).hex()
    peer = _members(rng, 1)[0]
    path = f"/internal/purge/{int(rng.integers(1, 99))}?x=%7C{int(rng.integers(0, 9))}"
    sig = psec.sign(secret, "post", path, body, now=now, nonce=nonce, peer=peer)
    assert sig == jsec.sign(secret, "post", path, body, now=now, nonce=nonce, peer=peer)
    for mod in (psec, jsec):
        assert mod.verify(secret, sig, "POST", path, body, now=now + 5, peer=peer)
        assert not mod.verify(secret, sig, "POST", path, body, now=now + 31, peer=peer)
        assert not mod.verify(secret, sig, "POST", path, body + b"x", now=now, peer=peer)
        assert not mod.verify(secret, sig, "POST", path, body, now=now, peer="http://other:1")
        assert not mod.verify(secret + "x", sig, "POST", path, body, now=now, peer=peer)
        assert not mod.verify(secret, "v1:1:abc", "POST", path, body, now=now, peer=peer)
        assert not mod.verify(secret, None, "POST", path, body, now=now, peer=peer)
    payload = rng.bytes(int(rng.integers(0, 200)))
    sealed = psec.seal(secret, payload)
    assert sealed == jsec.seal(secret, payload)
    assert psec.unseal(secret, sealed) == jsec.unseal(secret, sealed) == payload
    tampered = sealed[:-1] + bytes([sealed[-1] ^ 1]) if payload else sealed + b"x"
    assert psec.unseal(secret, tampered) is None is jsec.unseal(secret, tampered)
    assert psec.seal("", payload) == payload and psec.unseal("", payload) == payload


def test_nonce_cache_rejects_replays_like_jax():
    caches = [psec.NonceCache(max_peers=2, max_per_peer=3, skew_s=10.0),
              jsec.NonceCache(max_peers=2, max_per_peer=3, skew_s=10.0)]
    script = [("a", "n1", 0.0), ("a", "n1", 1.0), ("a", "n2", 2.0), ("b", "n1", 2.0),
              ("c", "n1", 3.0), ("a", "n1", 4.0), ("b", "n9", 5.0), ("b", "n9", 30.0),
              ("b", "n8", 31.0), ("b", "n7", 31.0), ("b", "n6", 31.0), ("b", "n8", 31.0)]
    for peer, nonce, now in script:
        seen = [c.seen_or_record(peer, nonce, now=1000.0 + now) for c in caches]
        assert seen[0] == seen[1], (peer, nonce, now)
    assert caches[0].snapshot() == caches[1].snapshot()
    assert caches[0].snapshot()["replays_rejected"] >= 1


class _Clock:
    """One fake wall and monotonic clock for both L2 modules."""

    @staticmethod
    def time():
        return 1.7e9

    @staticmethod
    def monotonic():
        return 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_l2_frame_bytes_match_jax(seed, monkeypatch):
    monkeypatch.setattr(jl2, "time", _Clock)
    monkeypatch.setattr(pl2, "time", _Clock)
    rng = np.random.default_rng(seed)
    body = rng.bytes(int(rng.integers(0, 4000)))
    name = f"image{seed}.png"
    epoch = None if seed % 2 else int(rng.integers(0, 1000))
    frame = pl2.encode_entry(PortTile(body, filename=name, stored_at=5.0), epoch=epoch)
    assert frame == jl2.encode_entry(JaxTile(body, filename=name, stored_at=5.0), epoch=epoch)
    entry, ep = pl2.decode_entry_epoch(frame)
    jentry, jep = jl2.decode_entry_epoch(frame)
    assert (entry.body, entry.etag, entry.filename, ep) == (
        jentry.body, jentry.etag, jentry.filename, jep)
    assert ep == epoch and entry.body == body
    for torn in (frame[:4], frame[:12], b"XXXXX" + frame[5:]):
        assert pl2.decode_entry_epoch(torn) == (None, None)


@pytest.mark.parametrize("seed", SEEDS)
def test_transfer_framing_matches_jax(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    items = [(k, rng.bytes(int(rng.integers(0, 500)))) for k in _keys(rng, 12)]
    payload = preplicate.encode_transfer(items)
    assert payload == jreplicate.encode_transfer(items)
    assert preplicate.decode_transfer(payload) == items
    cut = int(rng.integers(1, len(payload)))
    assert preplicate.decode_transfer(payload[:cut]) == jreplicate.decode_transfer(payload[:cut])
    # past the byte bound the tail is dropped, in both
    monkeypatch.setattr(preplicate, "MAX_TRANSFER_BYTES", 900)
    monkeypatch.setattr(jreplicate, "MAX_TRANSFER_BYTES", 900)
    assert preplicate.encode_transfer(items) == jreplicate.encode_transfer(items)
    assert len(preplicate.encode_transfer(items)) <= 900


@pytest.mark.parametrize("seed", SEEDS)
def test_digest_and_its_diff_match_jax(seed):
    rng = np.random.default_rng(seed)
    keys = _keys(rng, 40)
    items = [(k, None if i % 3 == 0 else int(rng.integers(0, 9))) for i, k in enumerate(keys)]
    body = prepair.build_digest(items)
    assert body == jrepair.build_digest(items)
    assert prepair.parse_digest(body) == jrepair.parse_digest(body)
    for junk in (b"", b"[]", b'{"entries": 3}', b'{"sum": 1, "entries": [1, {"k": 2}]}'):
        assert prepair.parse_digest(junk) == jrepair.parse_digest(junk)
    members = _members(rng, 3)
    ring = (PortRing(members, 32), JaxRing(members, 32))
    local = set(keys[::4])
    stale_epoch = int(rng.integers(0, 9))
    max_keys = int(rng.integers(1, 20))
    wanted = []
    for mod, r in zip((prepair, jrepair), ring):
        rep = mod.AntiEntropyRepairer(members[1], max_keys=max_keys)
        got = {}
        for peer in members:
            got[peer] = rep.select_missing(
                peer, prepair.parse_digest(body)["entries"], r, 2,
                has_local=lambda k: k in local,
                is_stale=lambda k, e: (e or 0) < stale_epoch)
        rep.note_synced(members[0], 7)
        got["unchanged"] = [rep.unchanged(members[0], 7) for _ in range(10)]
        got["rotation"] = [rep.next_peer(members) for _ in range(5)]
        got["snapshot"] = rep.snapshot()
        wanted.append(got)
    assert wanted[0] == wanted[1]


@pytest.mark.parametrize("seed", SEEDS)
def test_epoch_registry_matches_jax(seed):
    rng = np.random.default_rng(seed)
    regs = (pepochs.EpochRegistry(), jepochs.EpochRegistry())
    for key in _keys(rng, 30) + ["foreign", "", "img=x|"]:
        assert pepochs.image_id_of(key) == jepochs.image_id_of(key)
    for _ in range(50):
        image, epoch = int(rng.integers(1, 6)), int(rng.integers(0, 9))
        stamp = None if rng.random() < 0.3 else int(rng.integers(0, 9))
        key = f"img={image}|x=1"
        for r in regs:
            r.note(image, epoch)
        assert regs[0].known(image) == regs[1].known(image)
        assert regs[0].is_stale(key, stamp) == regs[1].is_stale(key, stamp)
    # no link: the bump is local-first and answers None
    bumped = [asyncio.run(r.bump(3)) for r in regs]
    assert bumped == [None, None]
    assert regs[0].known_map() == regs[1].known_map()
    assert regs[0].snapshot() == regs[1].snapshot()
    assert pepochs.epoch_key(7) == jepochs.epoch_key(7) == b"ompb:cluster:epoch:7"


@pytest.mark.parametrize("seed", SEEDS)
def test_integrity_and_corruption_ledger_match_jax(seed):
    rng = np.random.default_rng(seed)
    body = rng.bytes(100)
    etag = PortTile(body).etag
    assert etag == JaxTile(body).etag
    for tag, b in ((etag, body), (etag, body[:-1]), (None, body), ("", body)):
        assert pintegrity.body_matches(tag, b) == jintegrity.body_matches(tag, b)
    now = [0.0]
    ledgers = (pintegrity.CorruptionLedger(ttl_s=5.0, max_members=3, clock=lambda: now[0]),
               jintegrity.CorruptionLedger(ttl_s=5.0, max_members=3, clock=lambda: now[0]))
    members = _members(rng, 5) + [None]
    for _ in range(40):
        now[0] += float(rng.random() * 2.0)
        member = members[int(rng.integers(0, len(members)))]
        for led in ledgers:
            led.note(member)
        assert ledgers[0].counts() == ledgers[1].counts()
    assert ledgers[0].snapshot() == ledgers[1].snapshot()


@pytest.mark.parametrize("seed", SEEDS)
def test_replicator_choices_match_jax(seed):
    rng = np.random.default_rng(seed)
    members = _members(rng, 4)
    factor = int(rng.integers(1, 5))
    reps = (preplicate.HotSetReplicator(members[0], replication_factor=factor),
            jreplicate.HotSetReplicator(members[0], replication_factor=factor))
    rings = (PortRing(members), JaxRing(members))
    for key in _keys(rng, 30):
        estimate = None if rng.random() < 0.2 else int(rng.integers(0, 6))
        assert reps[0].targets(rings[0], key) == reps[1].targets(rings[1], key)
        assert reps[0].qualifies(key, estimate) == reps[1].qualifies(key, estimate)
        if reps[0].qualifies(key, estimate):
            for r in reps:
                r.mark_pushed(key)
    assert reps[0].snapshot() == reps[1].snapshot()


@pytest.mark.parametrize("observed", [None, 0.001, 0.1, 0.4])
def test_hedge_delay_matches_jax(observed, monkeypatch):
    policies = []
    for mod in (phedge, jhedge):
        policy = mod.HedgePolicy(enabled=True, min_s=0.02, max_s=0.25, fallback_s=0.05)
        monkeypatch.setattr(policy, "_observed_quantile", lambda: observed)
        policies.append(policy)
    assert policies[0].delay_s() == policies[1].delay_s()
    for p in policies:
        p.note("fired")
        p.note("peer_win")
    assert policies[0].snapshot() == policies[1].snapshot()
    assert phedge.HedgePolicy().delay_s() is None


def test_hedge_reads_the_recorders_peer_stage():
    """Without a patch the delay comes from the port's
    ``request_stage_seconds{stage="peer"}``: clamped to [min, max]."""
    from omero_ms_pixel_buffer_tpu_torch.obs.recorder import REQUEST_STAGE_SECONDS

    policy = phedge.HedgePolicy(enabled=True, min_s=0.02, max_s=0.25, fallback_s=0.1)
    REQUEST_STAGE_SECONDS.observe(0.03, stage="peer")
    q = REQUEST_STAGE_SECONDS.quantile(0.99, stage="peer")
    assert q is not None and policy.delay_s() == min(max(q, 0.02), 0.25)


@pytest.mark.parametrize("seed", SEEDS)
def test_quality_and_suspicion_match_jax(seed):
    rng = np.random.default_rng(seed)
    trackers = (psuspect.QualityTracker(), jsuspect.QualityTracker())
    for _ in range(300):
        status = int(rng.choice([200, 200, 200, 304, 404, 500, 503]))
        d = float(rng.exponential(0.05))
        for t in trackers:
            t.note(status, d)
    assert trackers[0].snapshot() == trackers[1].snapshot()
    assert trackers[0].take_window() == trackers[1].take_window()
    members = _members(rng, 5)
    fleet = {m: {"q": {"n": int(rng.integers(0, 40)), "err": int(rng.integers(0, 20)),
                       "p99_ms": float(rng.exponential(50.0))},
                 "bad": list(rng.choice(members, size=int(rng.integers(0, 3)), replace=False))}
             for m in members[1:]}
    failures = {m: int(rng.integers(0, 5)) for m in members}
    corruption = {members[int(rng.integers(0, 5))]: int(rng.integers(0, 3))}
    pol = (psuspect.SuspicionPolicy(enabled=True), jsuspect.SuspicionPolicy(enabled=True))
    verdicts = [p.verdicts(fleet, failures, corruption) for p in pol]
    assert verdicts[0] == verdicts[1]
    assert pol[0].demoted(fleet, verdicts[0], tuple(members)) == pol[1].demoted(
        fleet, verdicts[1], tuple(members))
    assert pol[0].snapshot() == pol[1].snapshot()
