"""The result cache's disk tier and its manifest (``cache/result_cache.py``
``DiskTier``, ``cache/plane/manifest.py``) against the JAX package's.

- ``DiskManifest``: the journal's bytes equal JAX's after every step of one
  admit, evict and compact sequence (both clocks injected); a torn tail
  is truncated, orphans and size-mismatched entries reconciled, and the
  restored entries equal, as JAX's.
- Cross-reading: a spill directory written by the JAX tier restores in the
  port's with the same keys, bytes and ETags, and the other way round.
- The tiered cache: one seeded get/put sequence gives the same hits (by
  tier), bodies and snapshots as JAX's; a disk failure passes through and
  opens ``cache:disk``; a purge racing a disk read serves nothing stale;
  ``invalidate_image`` empties both tiers.
- The front: a disk-resident tile passes the door gate when the queue is
  full, and a restarted server answers a spilled tile from disk.

Tolerance: zero."""

import asyncio
import json
import os
import shutil
import threading
import time as _time

import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu.cache import result_cache as jrc
from omero_ms_pixel_buffer_tpu.cache.plane import manifest as jman
from omero_ms_pixel_buffer_tpu.resilience import breaker as jbreaker
from omero_ms_pixel_buffer_tpu_torch.cache import result_cache as prc
from omero_ms_pixel_buffer_tpu_torch.cache.plane import manifest as pman
from omero_ms_pixel_buffer_tpu_torch.io import fetch as pfetch
from omero_ms_pixel_buffer_tpu_torch.resilience import breaker as pbreaker
from omero_ms_pixel_buffer_tpu_torch.resilience import configure
from omero_ms_pixel_buffer_tpu_torch.resilience.faultinject import INJECTOR, always
from omero_ms_pixel_buffer_tpu_torch.utils.config import Config


class _Time:
    """The JAX manifest module's ``time``: a wall and a monotonic clock
    stepped by the test."""

    def __init__(self):
        self.wall, self.mono = 1.7e9, 5000.0

    def time(self):
        return self.wall

    def monotonic(self):
        return self.mono

    perf_counter = staticmethod(_time.perf_counter)


@pytest.fixture
def clocks(monkeypatch):
    t = _Time()
    monkeypatch.setattr(jman, "time", t)
    return t


def _manifests(tmp_path, t, compact_bytes=1 << 20):
    dirs = [tmp_path / "jax", tmp_path / "port"]
    for d in dirs:
        d.mkdir(exist_ok=True)
    return (jman.DiskManifest(str(dirs[0]), compact_bytes),
            pman.DiskManifest(str(dirs[1]), compact_bytes, wall_clock=t.time,
                              mono_clock=t.monotonic))


def _jax_keys(snapshot: dict) -> dict:
    """A port manifest snapshot without its ``replay_s`` (not in JAX's)."""
    return {k: v for k, v in snapshot.items() if k != "replay_s"}


def _cache_view(snapshot: dict) -> dict:
    manifest = snapshot.get("disk", {}).get("manifest")
    if manifest is not None:
        snapshot["disk"]["manifest"] = _jax_keys(manifest)
    return snapshot


def _journal(m) -> bytes:
    with open(m.path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("seed", range(4))
def test_journal_bytes_match_jax(tmp_path, clocks, seed):
    rng = np.random.default_rng(seed)
    ms = _manifests(tmp_path, clocks)
    live = {}
    for step in range(120):
        clocks.wall += float(rng.random())
        clocks.mono += float(rng.random())
        key = f"img={int(rng.integers(1, 4))}|x={int(rng.integers(0, 9)) * 64}"
        op = rng.random()
        if op < 0.6:
            rec = (key, int(rng.integers(1, 5000)), f'"{step:032x}"', f"t{step}.png",
                   clocks.mono - float(rng.random()) * 3)
            for m in ms:
                m.record_admit(*rec)
            live[key] = rec
        elif op < 0.9:
            for m in ms:
                m.record_evict(key)
            live.pop(key, None)
        else:
            for m in ms:
                m.compact(list(live.values()))
        assert _journal(ms[1]) == _journal(ms[0]), step
        assert _jax_keys(ms[1].snapshot()) == ms[0].snapshot()
        assert ms[1].needs_compaction == ms[0].needs_compaction
    for m in ms:
        m.close()
        with pytest.raises(OSError):
            m.record_evict("late")


def _fname(key):
    return prc.DiskTier._fname(key)


def _seed_dir(d, entries, junk):
    """Data files for ``entries`` (key -> bytes) and the ``junk`` files."""
    for key, body in entries.items():
        (d / _fname(key)).write_bytes(body)
    for name, body in junk.items():
        (d / name).write_bytes(body)


def test_restore_reconciles_and_truncates_like_jax(tmp_path, clocks):
    """A journal with admits, an evict, an admit whose file is short, one
    whose file is missing, and a torn tail; orphan ``.tile``/``.tmp``
    files beside it: the same live entries (rebased on the monotonic
    clock), snapshot, compacted journal and directory as JAX's."""
    ms = _manifests(tmp_path, clocks)
    bodies = {f"img=1|k{i}": bytes([i]) * (100 + i) for i in range(6)}
    for m in ms:
        for i, (key, body) in enumerate(bodies.items()):
            m.record_admit(key, len(body), f'"e{i}"', f"f{i}", clocks.mono - i)
        m.record_admit("img=2|missing", 10, '"m"', "m", clocks.mono)
        m.record_evict("img=1|k1")
        m.close()
        with open(m.path, "ab") as fh:
            fh.write(b'0badc0de {"op":"admit","key":"img=9|torn"')
        d = tmp_path / ("jax" if m is ms[0] else "port")
        short = dict(bodies)
        short["img=1|k2"] = b"\x00" * 3  # size mismatch: dropped
        _seed_dir(d, short, {"deadbeef.tile": b"orphan", "x.tile.tmp": b"t", "keep.txt": b"k"})
    clocks.wall += 50.0
    clocks.mono += 7.0
    restored = [m.restore(_fname) for m in (
        jman.DiskManifest(str(tmp_path / "jax")),
        pman.DiskManifest(str(tmp_path / "port"), wall_clock=clocks.time,
                          mono_clock=clocks.monotonic))]
    assert restored[1] == restored[0]
    assert [e[0] for e in restored[1]] == ["img=1|k0", "img=1|k3", "img=1|k4", "img=1|k5"]
    again = [jman.DiskManifest(str(tmp_path / "jax")),
             pman.DiskManifest(str(tmp_path / "port"))]
    assert _journal(again[1]) == _journal(again[0])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert "deadbeef.tile" not in os.listdir(tmp_path / "port")


def test_restore_snapshot_counts_match_jax(tmp_path, clocks):
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "manifest.journal").write_bytes(b"garbage\n")
        _seed_dir(tmp_path / d, {}, {"a.tile": b"1", "b.tmp": b"2"})
    ms = [jman.DiskManifest(str(tmp_path / "jax")), pman.DiskManifest(str(tmp_path / "port"))]
    assert [m.restore(_fname) for m in ms] == [[], []]
    assert _jax_keys(ms[1].snapshot()) == ms[0].snapshot() == {
        "journal_bytes": 0, "replayed": 0, "torn_tail": True, "orphans_removed": 2,
        "dropped_missing": 0}
    assert ms[1].snapshot()["replay_s"] > 0


# -- the tier and the tiered cache --------------------------------------------------

@pytest.fixture
def _breakers():
    yield
    pbreaker.BOARD.reset()
    jbreaker.BOARD.reset()
    INJECTOR.clear()


def _flush(cache):
    """Wait for the cache's queued disk work."""
    if cache._io is not None:
        cache._io.submit(lambda: None).result(30)


def _bodies(seed, n):
    rng = np.random.default_rng(seed)
    return {f"img={1 + i % 3}|z=0|x={i * 64}|fmt=png": rng.bytes(int(rng.integers(300, 900)))
            for i in range(n)}


@pytest.mark.parametrize("writer", ["jax", "port"])
async def test_spill_directories_cross_restore(tmp_path, writer, _breakers):
    """Entries spilled by one package's tier restore in the other's, with
    the same keys, bodies and ETags (the disk half of one directory)."""
    bodies = _bodies(1, 24)
    mods = (jrc, prc) if writer == "jax" else (prc, jrc)
    first = mods[0].TileResultCache(memory_bytes=4000, disk_dir=str(tmp_path / "d"))
    for key, body in bodies.items():
        result = first.put(key, mods[0].CachedTile(body, filename=key[-7:]))
        if asyncio.iscoroutine(result):
            await result
    _flush(first)
    spilled = dict(first.disk._index)
    first.close()
    assert len(spilled) > 10
    second = mods[1].TileResultCache(memory_bytes=4000, disk_dir=str(tmp_path / "d"))
    try:
        assert list(second.disk._index) == list(spilled)
        assert second.disk.manifest.snapshot()["replayed"] == len(spilled)
        for key in spilled:
            entry = await second.get(key)
            assert entry.body == bodies[key] and entry.etag == prc.make_etag(bodies[key])
            assert entry.filename == key[-7:]
    finally:
        second.close()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("manifest", [True, False], ids=["manifest", "no-manifest"])
async def test_tiered_sequence_matches_jax(tmp_path, seed, manifest, _breakers, clocks,
                                          monkeypatch):
    """One seeded get/put/invalidate sequence through both tiered caches
    (memory of ~5 entries, disk of ~20; both manifests on one clock): the
    same answers, bodies and snapshots (the journal's size included), and
    equal ``tile_cache_requests_total`` by tier."""
    monkeypatch.setattr(pman, "time", clocks)
    rng = np.random.default_rng(seed)
    bodies = _bodies(seed, 40)
    keys = list(bodies)
    caches = [mod.TileResultCache(memory_bytes=3000, disk_dir=str(tmp_path / name),
                                  disk_bytes=14000, manifest=manifest)
              for mod, name in ((jrc, "jax"), (prc, "port"))]
    before = [dict(mod.CACHE_REQUESTS._values) for mod in (jrc, prc)]
    try:
        for _ in range(300):
            key = keys[int(rng.integers(0, len(keys)))]
            op = rng.random()
            if op < 0.05:
                image = int(rng.integers(1, 4))
                assert caches[1].invalidate_image(image) == caches[0].invalidate_image(image)
            elif op < 0.55:
                got = [await c.get(key) for c in caches]
                assert (got[1] is None) == (got[0] is None), key
                if got[1] is not None:
                    assert (got[1].body, got[1].etag) == (got[0].body, got[0].etag)
                    assert got[1].body == bodies[key]
            else:
                clocks.mono += 1.0
                await caches[0].put(key, jrc.CachedTile(bodies[key], stored_at=clocks.mono))
                caches[1].put(key, prc.CachedTile(bodies[key], stored_at=clocks.mono))
            for c in caches:
                _flush(c)
            snaps = [c.snapshot() for c in caches]
            assert _cache_view(snaps[1]) == snaps[0]
            assert [c.contains_any_tier(key) for c in caches] == [caches[0].contains_any_tier(
                key)] * 2
        deltas = [{k: v - b.get(k, 0) for k, v in mod.CACHE_REQUESTS._values.items()}
                  for mod, b in zip((jrc, prc), before)]
        assert deltas[1] == deltas[0]
        assert deltas[1][(("outcome", "hit"), ("tier", "disk"))] > 0
    finally:
        for c in caches:
            c.close()


async def test_disk_failure_passes_through_and_opens_the_breaker(tmp_path, _breakers):
    cache = prc.TileResultCache(memory_bytes=1500, disk_dir=str(tmp_path / "d"))
    try:
        bodies = _bodies(5, 6)
        for key, body in bodies.items():
            cache.put(key, prc.CachedTile(body))
        _flush(cache)
        spilled = list(cache.disk._index)
        assert spilled
        INJECTOR.install("cache.disk", always(OSError("disk gone")))
        errors = prc.CACHE_ERRORS._values.copy()
        for _ in range(6):
            assert await cache.get(spilled[0]) is None  # a miss, never a raise
        assert cache.snapshot()["disk"]["breaker"] == "open"
        calls = INJECTOR.calls("cache.disk")
        assert await cache.get(spilled[0]) is None
        assert INJECTOR.calls("cache.disk") == calls  # no disk work while open
        assert not cache._disk_usable()
        assert prc.CACHE_ERRORS._values == errors  # degraded, not an error
        cache.put("img=7|new", prc.CachedTile(b"m" * 100))
        assert (await cache.get("img=7|new")).body == b"m" * 100  # memory still serves
    finally:
        cache.close()


async def test_purge_racing_a_disk_read_serves_nothing_stale(tmp_path, _breakers):
    cache = prc.TileResultCache(memory_bytes=1500, disk_dir=str(tmp_path / "d"))
    try:
        for key, body in _bodies(6, 6).items():
            cache.put(key, prc.CachedTile(body))
        _flush(cache)
        key = next(iter(cache.disk._index))
        reading, release = threading.Event(), threading.Event()
        real_get = cache.disk.get

        def slow_get(k):
            reading.set()
            release.wait(10)
            return real_get(k)

        cache.disk.get = slow_get
        task = asyncio.ensure_future(cache.get(key))
        await asyncio.get_running_loop().run_in_executor(None, reading.wait, 10)
        image = int(key.split("|")[0][4:])
        cache.invalidate_image(image)
        release.set()
        assert await task is None
        assert cache.memory.peek(key) is None
        _flush(cache)
        assert not any(k.startswith(f"img={image}|") for k in cache.disk._index)
    finally:
        cache.close()


async def test_hits_readmit_and_invalidation_covers_both_tiers(tmp_path, _breakers):
    cache = prc.TileResultCache(memory_bytes=2000, disk_dir=str(tmp_path / "d"))
    try:
        bodies = _bodies(8, 9)
        for key, body in bodies.items():
            cache.put(key, prc.CachedTile(body))
        _flush(cache)
        on_disk = [k for k in bodies if cache.memory.peek(k) is None]
        assert on_disk and all(cache.contains_any_tier(k) for k in bodies)
        assert not cache.contains(on_disk[0]) and cache.contains_any_tier(on_disk[0])
        assert (await cache.get(on_disk[0])).body == bodies[on_disk[0]]
        assert cache.memory.peek(on_disk[0]) is not None  # re-admitted
        _flush(cache)
        for image in (1, 2, 3):
            cache.invalidate_image(image)
        _flush(cache)
        assert len(cache.memory) == 0 and len(cache.disk) == 0
        assert not any(name.endswith(".tile") for name in os.listdir(tmp_path / "d"))
        assert not any(cache.contains_any_tier(k) for k in bodies)
    finally:
        cache.close()


def test_unusable_directory_leaves_the_cache_memory_only(tmp_path, _breakers):
    blocker = tmp_path / "file"
    blocker.write_bytes(b"x")
    cache = prc.TileResultCache(disk_dir=str(blocker / "sub"))
    assert cache.disk is None and "disk" not in cache.snapshot()
    cache.close()


# -- the front ----------------------------------------------------------------------

IMG = np.random.default_rng(9).integers(0, 65535, (1, 1, 1, 512, 1024), dtype=np.uint16)
COOKIE = {"Cookie": "sessionid=ck"}


@pytest.fixture
def _process_defaults():
    yield
    default = Config.from_dict({"session-store": {"type": "memory"}})
    configure(default.resilience)
    pfetch.configure(default.io)
    pbreaker.BOARD.reset()


def _server(tmp_path, disk_dir):
    from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff

    from omero_ms_pixel_buffer_tpu_torch.auth.stores import MemorySessionStore
    from omero_ms_pixel_buffer_tpu_torch.http.server import wire

    path = tmp_path / "img.ome.tiff"
    if not path.exists():
        write_ome_tiff(str(path), IMG, tile_size=(256, 256))
        (tmp_path / "registry.json").write_text(
            json.dumps({"images": [{"id": 1, "path": str(path)}]}))
    raw = {"session-store": {"type": "memory"},
           "image-registry": str(tmp_path / "registry.json"),
           "cache": {"memory-mb": 1, "disk-dir": str(disk_dir),
                     "prefetch": {"enabled": False}}}
    return wire(Config.from_dict(raw), session_store=MemorySessionStore({"ck": "key1"}),
                device="cpu")


async def _get(port, url):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"GET {url} HTTP/1.1\r\nHost: x\r\nCookie: sessionid=ck\r\n"
                     "Connection: close\r\n\r\n".encode())
        raw = await reader.read()
    finally:
        writer.close()
    top, _, body = raw.partition(b"\r\n\r\n")
    lines = top.decode("latin-1").split("\r\n")
    return int(lines[0].split()[1]), dict(ln.split(": ", 1) for ln in lines[1:]), body


TILES = [f"/tile/1/0/0/0?x={x}&y={y}&w=256&h=256&format=png"
         for y in (0, 256) for x in (0, 256, 512, 768)]


async def test_restarted_server_answers_spilled_tiles_from_disk(tmp_path, _process_defaults):
    """Eight 256² uint16 noise tiles (~130 kB each) through a 1 MiB memory
    tier: the first ones spill; after a restart on the same directory every
    spilled tile answers ``X-Cache: hit`` with the first pass's bytes and
    ETag, counted as a disk hit, and ``/healthz`` shows the replay."""
    disk = tmp_path / "spill"
    server = _server(tmp_path, disk)
    port = await server.start("127.0.0.1", 0)
    first = {}
    try:
        for url in TILES:
            status, hdrs, body = await _get(port, url)
            assert (status, hdrs["X-Cache"]) == (200, "miss")
            first[url] = (body, hdrs["ETag"])
        _flush(server.cache)
        spilled = len(server.cache.disk)
        assert spilled > 0
    finally:
        await server.close()
        server.pipeline.close()
    server = _server(tmp_path, disk)
    port = await server.start("127.0.0.1", 0)
    try:
        manifest = server.health()["result_cache"]["disk"]["manifest"]
        assert manifest["replayed"] == spilled and manifest["torn_tail"] is False
        before = dict(prc.CACHE_REQUESTS._values)
        hits = 0
        for url in TILES:
            status, hdrs, body = await _get(port, url)
            assert (body, hdrs["ETag"]) == first[url]
            hits += hdrs["X-Cache"] == "hit"
        disk_hits = (prc.CACHE_REQUESTS._values[(("outcome", "hit"), ("tier", "disk"))]
                     - before.get((("outcome", "hit"), ("tier", "disk")), 0))
        assert hits == disk_hits == spilled
    finally:
        await server.close()
        server.pipeline.close()


async def test_disk_resident_tile_passes_the_door_gate(tmp_path, _process_defaults,
                                                       monkeypatch):
    """With the wait queue full, a request whose tile is only on disk is
    served (``contains_any_tier``); one that is nowhere sheds at the door."""
    server = _server(tmp_path, tmp_path / "spill")
    port = await server.start("127.0.0.1", 0)
    try:
        for url in TILES:
            assert (await _get(port, url))[0] == 200
        _flush(server.cache)
        quality = server.pipeline.encode_signature()
        resident = [url for url in TILES
                    if server._door_probe_key(url.split("?")[0], dict(
                        kv.split("=") for kv in url.split("?")[1].split("&")))
                    in server.cache.disk._index
                    and not server.cache.contains(server._door_probe_key(
                        url.split("?")[0],
                        dict(kv.split("=") for kv in url.split("?")[1].split("&"))))]
        assert resident and quality
        monkeypatch.setattr(server.scheduler, "would_overflow_shed", lambda priority: True)
        status, hdrs, _ = await _get(port, resident[0])
        assert (status, hdrs["X-Cache"]) == (200, "hit")
        status, hdrs, body = await _get(port, "/tile/1/0/0/0?x=0&y=0&w=100&h=100&format=png")
        assert (status, body) == (503, b"Service overloaded") and "Retry-After" in hdrs
    finally:
        await server.close()
        server.pipeline.close()


def test_journal_survives_a_copy(tmp_path, clocks):
    """The journal is position-independent: a copied spill directory
    restores the same entries (the directory is the only state)."""
    ms = _manifests(tmp_path, clocks)
    body = b"z" * 77
    for m in ms:
        m.record_admit("img=1|a", len(body), '"e"', "a.png", clocks.mono)
        m.close()
        d = os.path.dirname(m.path)
        (tmp_path / os.path.basename(d) / _fname("img=1|a")).write_bytes(body)
        shutil.copytree(d, d + "-copy")
    got = [jman.DiskManifest(str(tmp_path / "jax-copy")).restore(_fname),
           pman.DiskManifest(str(tmp_path / "port-copy"), wall_clock=clocks.time,
                             mono_clock=clocks.monotonic).restore(_fname)]
    assert got[1] == got[0] and got[1][0][:4] == ("img=1|a", 77, '"e"', "a.png")
