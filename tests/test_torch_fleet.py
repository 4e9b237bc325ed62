"""The port's static fleet (``cluster.members`` over loopback, the port's
RESP2 stub as the shared Redis) against the JAX package's, on the CPU
(the kernels' plain versions). Fleets of two are built as
``tests/test_cache_plane.py`` builds them: real sockets, one image
fixture, prefetch off (speculative renders would blur the render-once
counts). Requests are raw HTTP/1.1 over asyncio streams, so every target
reaches a front byte for byte as written.

- One request script against a JAX fleet, then against a port fleet on
  the same two ports (so both rings agree on every owner): statuses,
  bodies, ETags, ``X-Cache``, renders per replica, the L2 entries' bytes
  in the stub (both L2 modules' ``time`` on one fake clock), the bodies
  of ``/internal/digest``, ``/internal/transfer`` and ``/internal/pull``,
  the ``/healthz`` ``cluster`` keys, an invalidation's epoch and DELs,
  the re-reads after it and a drain's answer.
- Render-once, cross-process single flight, epoch invalidation (a purge
  that races a fill; one that races a peer fetch), the signature checks,
  replication and anti-entropy repair, drain with handoff (the cache and
  the session channels), chaos (a dead member, a hung or closing Redis:
  local renders, never a 5xx), and a mixed fleet of one JAX and one port
  replica on one ring and one stub (render-once, identical bytes, signed
  hops on a percent-escaped query in both directions).

Tolerance: zero (equal bytes and counts)."""

import asyncio
import json
import socket
from urllib.parse import parse_qsl, urlsplit

import numpy as np
import pytest
from aiohttp import web

from omero_ms_pixel_buffer_tpu.auth.stores import MemorySessionStore as JaxMemoryStore
from omero_ms_pixel_buffer_tpu.cache.plane import l2 as jl2
from omero_ms_pixel_buffer_tpu.http.server import PixelBufferApp
from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu.resilience import configure as jax_configure
from omero_ms_pixel_buffer_tpu.resilience.breaker import BOARD as JAX_BOARD
from omero_ms_pixel_buffer_tpu.utils.config import Config as JaxConfig
from omero_ms_pixel_buffer_tpu_torch.auth.stores import MemorySessionStore
from omero_ms_pixel_buffer_tpu_torch.cache.plane import l2 as pl2
from omero_ms_pixel_buffer_tpu_torch.cache.plane.coordinator import PLANE_PURGES
from omero_ms_pixel_buffer_tpu_torch.cache.plane.resp_stub import InMemoryRespServer
from omero_ms_pixel_buffer_tpu_torch.cluster.security import sign
from omero_ms_pixel_buffer_tpu_torch.http.server import aiohttp_path_qs, wire
from omero_ms_pixel_buffer_tpu_torch.io import fetch
from omero_ms_pixel_buffer_tpu_torch.resilience import breaker as pbreaker
from omero_ms_pixel_buffer_tpu_torch.resilience import configure
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import TileCtx
from omero_ms_pixel_buffer_tpu_torch.utils.config import Config

IMG = np.random.default_rng(15).integers(0, 60000, (1, 1, 1, 256, 256), dtype=np.uint16)
AUTH = {"Cookie": "sessionid=ck"}
SECRET = "fleet-secret"
TILES = [f"/tile/1/0/0/0?x={64 * (i % 4)}&y={64 * (i // 4)}&w=64&h=64&format=png"
         for i in range(16)]
EPOCH_KEY = b"ompb:cluster:epoch:1"


@pytest.fixture(autouse=True)
def _process_defaults():
    """Both fronts configure process-wide layers (breaker boards, the io
    timeout, the read plane): restore the defaults."""
    yield
    default = Config.from_dict({"session-store": {"type": "memory"}})
    configure(default.resilience)
    fetch.configure(default.io)
    pbreaker.BOARD.reset()
    jax_configure(JaxConfig.from_dict({"session-store": {"type": "memory"}}).resilience)
    JAX_BOARD.reset()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _request(port, method, target, headers=None, body=b""):
    """(status, headers with their names lower-cased, body) of one request
    on a fresh connection."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        head = (f"{method} {target} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n"
                f"Content-Length: {len(body)}\r\n")
        for k, v in (headers or {}).items():
            head += f"{k}: {v}\r\n"
        writer.write(head.encode("latin-1") + b"\r\n" + body)
        await writer.drain()
        data = await reader.read()
    finally:
        writer.close()
    top, _, rest = data.partition(b"\r\n\r\n")
    lines = top.decode("latin-1").split("\r\n")
    hdrs = {k.lower(): v for k, v in (ln.split(": ", 1) for ln in lines[1:])}
    if "chunked" in hdrs.get("transfer-encoding", ""):
        out = b""
        while rest:
            size, _, rest = rest.partition(b"\r\n")
            n = int(size, 16)
            if n == 0:
                break
            out, rest = out + rest[:n], rest[n + 2:]
        rest = out
    return int(lines[0].split()[1]), hdrs, rest


def _signed(method, target, peer, body=b"", secret=SECRET, **extra):
    return {"X-OMPB-Peer": peer, "X-OMPB-Sig": sign(secret, method, target, body, peer=peer),
            **extra}


class Replica:
    """One running replica of either package: its URL, port, plane,
    render count (lanes the port's batcher ran; the JAX pipeline's
    handled contexts) and teardown."""

    def __init__(self, kind, url, port, app):
        self.kind, self.url, self.port, self.app = kind, url, port, app
        self.runner = None
        self._jax_renders = 0

    @property
    def plane(self):
        return self.app.cache_plane

    @property
    def cache(self):
        return self.app.cache if self.kind == "port" else self.app.result_cache

    def renders(self) -> int:
        return self.app.worker.lanes if self.kind == "port" else self._jax_renders

    def count_jax_renders(self):
        pipe = self.app.pipeline
        inner_handle, inner_batch = pipe.handle, pipe.handle_batch

        def handle(ctx):
            self._jax_renders += 1
            return inner_handle(ctx)

        def handle_batch(ctxs):
            self._jax_renders += len(ctxs)
            return inner_batch(ctxs)

        pipe.handle, pipe.handle_batch = handle, handle_batch

    async def health(self) -> dict:
        return json.loads((await _request(self.port, "GET", "/healthz"))[2])

    async def get(self, target, headers=None):
        return await _request(self.port, "GET", target, {**AUTH, **(headers or {})})

    async def close(self):
        if self.kind == "port":
            await self.app.close()
            self.app.pipeline.close()
        else:
            await self.runner.cleanup()


class Fleet:
    def __init__(self, replicas, stub, members):
        self.replicas, self.stub, self.members = replicas, stub, members
        # the tasks a plane keeps for good (the repair loop)
        self.resident = [len(r.plane._tasks) for r in replicas]

    def __getitem__(self, i):
        return self.replicas[i]

    def renders(self):
        return [r.renders() for r in self.replicas]

    async def settle(self, timeout=10.0):
        """Until every plane's fire-and-forget work (L2 puts, replica
        pushes) has landed."""
        loop = asyncio.get_running_loop()
        end = loop.time() + timeout
        while any(len(r.plane._tasks) > n for r, n in zip(self.replicas, self.resident)):
            assert loop.time() < end, "plane tasks did not settle"
            await asyncio.sleep(0.01)

    def l2_entries(self) -> dict:
        return {k: v[0] for k, v in self.stub.data.items() if k.startswith(b"ompb:")}

    async def close(self):
        for r in self.replicas:
            await r.close()
        if self.stub is not None and self.stub._server is not None:
            await self.stub.close()


def _registry(tmp_path) -> str:
    reg = tmp_path / "registry.json"
    if not reg.exists():
        path = str(tmp_path / "img.ome.tiff")
        write_ome_tiff(path, IMG, tile_size=(64, 64), pyramid_levels=2)
        reg.write_text(json.dumps({"images": [{"id": 1, "path": path}]}))
    return str(reg)


async def _fleet(tmp_path, kinds, l2=True, secret=SECRET, cluster=None, extra=None,
                 dead=(), ports=None, stub=None) -> Fleet:
    """Replicas of ``kinds`` ("jax" or "port") on loopback, one ring,
    one stub (unless ``l2`` is off); ``dead`` adds ring members nobody
    listens on."""
    if l2 and stub is None:
        stub = InMemoryRespServer()
        await stub.start()
    ports = list(ports) if ports is not None else [_free_port() for _ in kinds]
    members = [f"http://127.0.0.1:{p}" for p in ports] + list(dead)
    replicas = []
    for i, (kind, port) in enumerate(zip(kinds, ports)):
        replicas.append(await _replica(tmp_path, kind, port, members, stub if l2 else None,
                                       secret, cluster, extra))
    return Fleet(replicas, stub, members)


async def _replica(tmp_path, kind, port, members, stub, secret, cluster=None, extra=None):
    """One started replica of ``kind`` serving on ``port``, seeded with
    ``members``."""
    url = f"http://127.0.0.1:{port}"
    cl = {"members": members, "self": url, "peer-timeout-ms": 2000,
          **({"l2": {"uri": stub.uri}} if stub is not None else {}),
          **({"secret": secret} if secret else {}), **(cluster or {})}
    raw = {"session-store": {"type": "memory"}, "image-registry": _registry(tmp_path),
           "backend": {"batching": {"coalesce-window-ms": 1.0}},
           "cache": {"prefetch": {"enabled": False}}, "cluster": cl, **(extra or {})}
    if kind == "port":
        server = wire(Config.from_dict(raw), device="cpu",
                      session_store=MemorySessionStore({"ck": "omero-key-1"}))
        await server.start("127.0.0.1", port)
        return Replica("port", url, port, server)
    app = PixelBufferApp(JaxConfig.from_dict(raw),
                         session_store=JaxMemoryStore({"ck": "omero-key-1"}))
    rep = Replica("jax", url, port, app)
    rep.count_jax_renders()
    rep.runner = web.AppRunner(app.make_app())
    await rep.runner.setup()
    await web.TCPSite(rep.runner, "127.0.0.1", port).start()
    return rep


def _l2_purges() -> float:
    """The port's L2 purges so far (``tile_cache_plane_purges_total``)."""
    return sum(v for labels, v in PLANE_PURGES.samples().items()
               if ("target", "l2") in labels)


async def _poll(cond, what, timeout=10.0):
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while not cond():
        assert loop.time() < end, what
        await asyncio.sleep(0.01)


class _Clock:
    """One wall and monotonic clock for both L2 modules: their frames'
    ``wall`` field is then the same number."""

    @staticmethod
    def time():
        return 1.7e9

    @staticmethod
    def monotonic():
        return 0.0


def _strip_took(answer: dict) -> dict:
    answer = json.loads(json.dumps(answer))
    answer["stats"].pop("took_s")
    return answer


async def _script(fleet: Fleet) -> dict:
    """The request script of the fleet-against-fleet comparison."""
    a, b = fleet[0], fleet[1]
    out = {"reads": [], "renders": []}
    for i, path in enumerate(TILES[:8]):
        for r in (fleet[i % 2], fleet[(i + 1) % 2]):
            status, hdrs, body = await r.get(path)
            out["reads"].append((status, hdrs.get("etag"), hdrs.get("x-cache"), body))
    for path in TILES[:8]:  # a third touch: the keys cross the replication bar
        out["reads"].append((await a.get(path))[0])
    await fleet.settle()
    out["renders"].append(fleet.renders())
    out["l2"] = fleet.l2_entries()
    internal = []
    for target, r, peer in (("/internal/digest", a, b.url), ("/internal/transfer", b, a.url),
                            ("/internal/digest?limit=3", b, a.url),
                            ("/internal/transfer?limit=2", a, b.url)):
        status, hdrs, body = await _request(r.port, "GET", target, _signed("GET", target, peer))
        internal.append((target, status, hdrs.get("content-type"), body))
    keys = [e["k"] for e in json.loads(internal[0][3])["entries"]][:5] + ["img=9|absent"]
    pull = json.dumps({"keys": keys}).encode()
    status, hdrs, body = await _request(b.port, "POST", "/internal/pull",
                                        _signed("POST", "/internal/pull", a.url, pull), pull)
    internal.append(("/internal/pull", status, hdrs.get("content-type"), body))
    out["internal"] = internal
    out["cluster_keys"] = [sorted((await r.health())["cluster"]) for r in fleet.replicas]
    out["replication"] = [r.plane.replicator.snapshot() for r in fleet.replicas]
    # the metadata resolver's listener on a: epoch bump, L2 DELs, the
    # signed purge fan-out to b
    a.app._invalidate_image(1)
    await _poll(lambda: fleet.stub.data.get(EPOCH_KEY, (b"0",))[0] == b"1"
                and b.plane.epochs.known(1) == 1, "the invalidation did not fan out")
    await _poll(lambda: not any(k.startswith(b"ompb:tile:") for k in fleet.stub.data),
                "the L2 DELs did not land")
    out["l2_after_purge"] = fleet.l2_entries()
    for i, path in enumerate(TILES[:4]):
        status, hdrs, body = await fleet[(i + 1) % 2].get(path)
        out["reads"].append((status, hdrs.get("etag"), hdrs.get("x-cache"), body))
    await fleet.settle()
    out["renders"].append(fleet.renders())
    target = "/internal/drain?wait=1"
    status, _, body = await _request(b.port, "POST", target, _signed("POST", target, a.url))
    out["drain"] = (status, _strip_took(json.loads(body)))
    out["purge_epochs"] = [r.plane.epochs.snapshot() for r in fleet.replicas]
    return out


async def test_port_fleet_matches_jax_fleet(tmp_path, monkeypatch):
    monkeypatch.setattr(jl2, "time", _Clock)
    monkeypatch.setattr(pl2, "time", _Clock)
    ports = [_free_port(), _free_port()]
    results = {}
    for kind in ("jax", "port"):
        fleet = await _fleet(tmp_path, [kind, kind], ports=ports,
                             cluster={"replication-factor": 2})
        try:
            results[kind] = await _script(fleet)
        finally:
            await fleet.close()
    jax_run, port_run = results["jax"], results["port"]
    assert all(r[0] == 200 for r in port_run["reads"][:16])
    assert "miss" in {r[2] for r in port_run["reads"][:16]}
    for key in ("reads", "renders", "l2", "l2_after_purge", "cluster_keys", "replication",
                "drain", "purge_epochs"):
        assert port_run[key] == jax_run[key], key
    for p, j in zip(port_run["internal"], jax_run["internal"]):
        assert p == j, p[0]
    assert sum(port_run["renders"][0]) == 8  # each key rendered once in the fleet
    assert len(port_run["l2"]) == 8 and port_run["drain"][1]["state"] == "drained"


@pytest.mark.parametrize("l2", [True, False], ids=["l2", "ring-only"])
async def test_render_once_across_port_replicas(tmp_path, l2):
    fleet = await _fleet(tmp_path, ["port", "port"], l2=l2)
    try:
        etags = {}
        for i, path in enumerate(TILES[:8]):
            first = await fleet[i % 2].get(path)
            second = await fleet[(i + 1) % 2].get(path)
            assert first[0] == second[0] == 200
            assert first[2] == second[2] and first[1]["etag"] == second[1]["etag"]
            assert second[1]["x-cache"] in ("l2-hit", "peer-hit", "hit")
            etags[path] = first[1]["etag"]
        assert sum(fleet.renders()) == 8
        assert len(set(etags.values())) == 8
    finally:
        await fleet.close()


async def test_cross_process_single_flight(tmp_path):
    """Concurrent cold misses for one tile on both replicas: the non-owner
    peer-fetches, joins the owner's flight, and the fleet renders once."""
    fleet = await _fleet(tmp_path, ["port", "port"], l2=False)
    try:
        for r in fleet.replicas:
            inner = r.app.worker.handle

            async def slow(ctx, _inner=inner):
                await asyncio.sleep(0.1)  # hold the flight open
                return await _inner(ctx)

            r.app.worker.handle = slow
        answers = await asyncio.gather(*(fleet[i % 2].get(TILES[0]) for i in range(6)))
        assert {a[0] for a in answers} == {200} and len({a[2] for a in answers}) == 1
        assert sum(fleet.renders()) == 1
    finally:
        await fleet.close()


async def test_epoch_invalidation(tmp_path):
    fleet = await _fleet(tmp_path, ["port", "port"])
    a, b = fleet[0], fleet[1]
    try:
        before = {p: (await a.get(p))[2] for p in TILES[:4]}
        await fleet.settle()
        assert sum(fleet.renders()) == 4
        a.app._invalidate_image(1)
        await _poll(lambda: fleet.stub.data.get(EPOCH_KEY, (b"0",))[0] == b"1"
                    and b.plane.epochs.known(1) == 1, "no fan-out")
        await _poll(lambda: not any(k.startswith(b"ompb:tile:") for k in fleet.stub.data),
                    "no DELs")
        health = await a.health()
        assert health["cluster"]["epochs"]["bumps"] == 1
        for p in TILES[:4]:
            status, hdrs, body = await b.get(p)
            assert status == 200 and body == before[p] and hdrs["x-cache"] in ("miss", "peer-hit")
        await fleet.settle()
        assert sum(fleet.renders()) == 8  # each key rendered once more, by its owner
        # an entry stamped before the bump reads as a miss (stale epoch)
        key = next(k for k in fleet.stub.data if k.startswith(b"ompb:tile:"))
        entry, _ = pl2.decode_entry_epoch(fleet.stub.data[key][0])
        fleet.stub.data[key] = (pl2.encode_entry(entry, epoch=0), None)
        got, epoch = await a.plane.l2.get_with_epoch(key.decode()[len("ompb:tile:"):])
        assert got is None and epoch == 1
        assert a.plane.epochs.stale_reads >= 1
    finally:
        await fleet.close()


async def _hold_owner(fleet, path):
    """(owner, other, release event, cache key) of ``path``: the owner's
    renders wait on the event."""
    parts = urlsplit(path)
    ctx = TileCtx.from_params({"imageId": "1", "z": "0", "c": "0", "t": "0",
                               **dict(parse_qsl(parts.query))}, "omero-key-1")
    key = ctx.cache_key(fleet[0].app.pipeline.encode_signature())
    owner_url = fleet[0].plane.ring.owner(key)
    owner = next(r for r in fleet.replicas if r.url == owner_url)
    other = next(r for r in fleet.replicas if r is not owner)
    release = asyncio.Event()
    inner = owner.app.worker.handle

    async def held(ctx):
        await release.wait()
        return await inner(ctx)

    owner.app.worker.handle = held
    return owner, other, release, key


async def test_purge_racing_a_fill_is_stale_on_arrival(tmp_path):
    """The owner's render is in flight when the image's epoch is bumped:
    its fill is not admitted to the owner's cache (the generation guard)
    and its L2 entry, stamped with the pre-render epoch, reads as a miss."""
    fleet = await _fleet(tmp_path, ["port", "port"])
    try:
        owner, other, release, key = await _hold_owner(fleet, TILES[5])
        pending = asyncio.ensure_future(owner.get(TILES[5]))
        await _poll(lambda: owner.app.scheduler.snapshot()["granted"]["interactive"] >= 1,
                    "the request did not reach the render")
        dels = _l2_purges()
        owner.app._invalidate_image(1)
        # the bump, then the L2 DELs, land before the render ends
        await _poll(lambda: fleet.stub.data.get(EPOCH_KEY, (b"0",))[0] == b"1"
                    and _l2_purges() > dels, "no bump and DELs")
        release.set()
        status, _, body = await pending
        assert status == 200
        await fleet.settle()
        assert not owner.cache.contains(key)
        assert fleet.stub.data.get(b"ompb:tile:" + key.encode()) is not None  # written...
        assert (await owner.plane.l2.get(key)) is None  # ...but stale on arrival
        status, hdrs, again = await other.get(TILES[5])
        assert status == 200 and again == body and hdrs["x-cache"] == "peer-hit"
        assert sum(fleet.renders()) == 2
    finally:
        await fleet.close()


async def test_purge_racing_a_peer_fetch_blocks_readmission(tmp_path):
    """A peer purge lands on the non-owner while its owner hop is in
    flight: the answer is served, but not admitted to its cache."""
    fleet = await _fleet(tmp_path, ["port", "port"], l2=False)
    try:
        owner, other, release, key = await _hold_owner(fleet, TILES[6])
        pending = asyncio.ensure_future(other.get(TILES[6]))
        await _poll(lambda: owner.app.scheduler.snapshot()["granted"]["interactive"] >= 1,
                    "the hop did not reach the owner")
        target = "/internal/purge/1"
        status, _, _ = await _request(other.port, "POST", target,
                                      _signed("POST", target, owner.url))
        assert status == 200
        release.set()
        status, hdrs, _ = await pending
        assert status == 200 and hdrs["x-cache"] == "peer-hit"
        assert not other.cache.contains(key) and owner.cache.contains(key)
    finally:
        await fleet.close()


SIG_CASES = ["unsigned", "forged", "replayed", "v1", "rotated_peer", "no_peer_marker"]


@pytest.mark.parametrize("case", SIG_CASES)
async def test_signature_checks_match_jax(tmp_path, case):
    """403 for unsigned, forged, replayed, v1-format and re-attributed
    requests on the internal surface and the serving hop, in both
    packages; a fresh signature passes."""
    fleet = await _fleet(tmp_path, ["port", "jax"])
    try:
        answers = []
        for r in fleet.replicas:
            peer = fleet[1].url if r is fleet[0] else fleet[0].url
            statuses = []
            for method, target in (("POST", "/internal/purge/1"), ("GET", TILES[1])):
                good = _signed(method, target, peer)
                if case == "unsigned":
                    h = {"X-OMPB-Peer": peer}
                elif case == "forged":
                    h = _signed(method, target, peer, secret="not-the-secret")
                elif case == "replayed":
                    statuses.append((await _request(r.port, method, target, {**AUTH, **good}))[0])
                    h = good
                elif case == "v1":
                    h = {"X-OMPB-Peer": peer, "X-OMPB-Sig": "v1:" + good["X-OMPB-Sig"][3:]}
                elif case == "rotated_peer":
                    h = {**good, "X-OMPB-Peer": "http://127.0.0.1:1"}
                else:
                    h = {"X-OMPB-Sig": good["X-OMPB-Sig"]}
                status, _, body = await _request(r.port, method, target, {**AUTH, **h})
                statuses.append((status, body if status == 403 else b""))
            answers.append(statuses)
        assert answers[0] == answers[1]
        flat = [s[0] if isinstance(s, tuple) else s for s in answers[0]]
        if case == "no_peer_marker":  # the purge needs the marker; the GET is plain traffic
            assert flat == [403, 200]
        elif case == "replayed":
            assert flat == [200, 403, 200, 403]
        else:
            assert flat == [403, 403]
    finally:
        await fleet.close()


PATH_QS_TARGETS = [
    "/tile/1/0/0/0?x=0&y=0&w=64&h=64&format=png",
    "/render/1/0/0/0?c=1|0:4000$FF0000,2|0:4000$00FF00&p=intmax",
    "/render/1/0/0/0?c=1%7C0:4000%24FF0000&m=g",
    "/render/1/0/0/0?roi=%5B%7B%22type%22%3A%22rect%22%7D%5D",
    "/tile/1/0/0/0?a=%41%42&b=%2f%2F&c=%20+x",
    "/tile/%31/0/0/0?x=1",
    "/dzi/1_files/9/0_0.png?q=%zz",
    "/a/b/../c?x=1#frag",
    "/x?",
    "/internal/drain?wait=1",
]


@pytest.mark.parametrize("target", PATH_QS_TARGETS)
async def test_signed_path_is_aiohttps_path_qs(target):
    """The string the HMAC covers: the port's spelling of a target equals
    ``request.path_qs`` of the JAX package's aiohttp front."""
    seen = []

    async def handler(request):
        seen.append(request.path_qs)
        return web.Response(text="ok")

    app = web.Application()
    app.router.add_route("*", "/{tail:.*}", handler)
    runner = web.AppRunner(app)
    await runner.setup()
    port = _free_port()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    try:
        assert (await _request(port, "GET", target))[0] == 200
    finally:
        await runner.cleanup()
    assert aiohttp_path_qs(target) == seen[0]


async def test_replication_and_repair(tmp_path):
    fleet = await _fleet(tmp_path, ["port", "port"], l2=False,
                         cluster={"replication-factor": 2, "repair": {"interval-s": 3600}})
    a, b = fleet[0], fleet[1]
    try:
        owned = [p for p in TILES if (await a.get(p))[1]["x-cache"] == "miss"]
        for p in owned:
            assert (await a.get(p))[1]["x-cache"] == "hit"  # the third touch: hot
        await fleet.settle()
        rep_a, rep_b = a.plane.replicator.snapshot(), b.plane.replicator.snapshot()
        assert rep_a["pushed"] == len(owned) > 0 and rep_b["received"] == len(owned)
        keys = [k for k, _ in b.cache.memory.items_snapshot()
                if b.plane.ring.owner(k) == a.url]  # the replicas b holds for a
        assert len(keys) == len(owned)
        lost = keys[:3]  # up to three (the ring decides how many a owns)
        for k in lost:
            b.cache.memory.remove_prefix(k)
        assert not any(b.cache.contains(k) for k in lost)
        pulled = await b.plane.repair_round()
        assert pulled == len(lost) and all(b.cache.contains(k) for k in lost)
        assert await b.plane.repair_round() == 0  # in sync
        snap = (await b.health())["cluster"]["repair"]
        assert snap["pulled"] == len(lost) and snap["rounds"] == 2
        assert (await a.health())["cluster"]["repair"]["digests_served"] == 2
        renders = fleet.renders()
        for p in owned:  # b serves the replicas: no render
            assert (await b.get(p))[1]["x-cache"] == "hit"
        assert fleet.renders() == renders
    finally:
        await fleet.close()


async def test_drain_hands_off_cache_and_sessions(tmp_path):
    fleet = await _fleet(tmp_path, ["port", "port"])
    a, b = fleet[0], fleet[1]
    try:
        bodies = {p: (await b.get(p))[2] for p in TILES}
        await fleet.settle()
        channel = b.app.session_channels.register(1, "sid", "omero-key-1", "sse")
        held = len(b.cache.memory)
        target = "/internal/drain?wait=1"
        status, _, body = await _request(b.port, "POST", target, _signed("POST", target, a.url))
        answer = json.loads(body)
        assert status == 200 and answer["state"] == "drained"
        stats = answer["stats"]
        assert stats["handoff"]["pushed"] == stats["handoff"]["entries"] == held > 0
        assert stats["sessions"] == {"channels": 1, "successor": a.url, "pushed": True}
        assert stats["quiesced"] and stats["lease_released"] and not stats["announced"]
        assert channel.queue.get_nowait() == {"type": "reconnect", "reconnect": a.url}
        assert (await a.health())["session"]["handoff_in"] == 1
        assert b.app.scheduler.draining
        renders = fleet.renders()
        for p in TILES:
            status, hdrs, got = await a.get(p)
            assert status == 200 and got == bodies[p] and hdrs["x-cache"] == "hit"
        assert fleet.renders() == renders
        # idempotent: a second trigger joins the first run
        status, _, body = await _request(b.port, "POST", target, _signed("POST", target, a.url))
        assert json.loads(body)["stats"]["handoff"] == stats["handoff"]
        # SIGTERM's path: the same drain, then the caller's stop
        stopped = asyncio.Event()
        assert b.app.drain_on_signal(stopped.set)
        await asyncio.wait_for(stopped.wait(), 5)
    finally:
        await fleet.close()


@pytest.mark.parametrize("chaos", ["dead_member", "redis_hang", "redis_close"])
async def test_chaos_degrades_to_local_renders(tmp_path, chaos):
    dead = (f"http://127.0.0.1:{_free_port()}",) if chaos == "dead_member" else ()
    fleet = await _fleet(tmp_path, ["port", "port"], dead=dead,
                         extra={"resilience": {"io-timeout-ms": 200}})
    try:
        if chaos != "dead_member":
            fleet.stub.fail_mode = chaos[len("redis_"):]
        answers = [await fleet[i % 2].get(p) for i, p in enumerate(TILES)]
        assert {a[0] for a in answers} == {200}
        for (status, hdrs, body), p in zip(answers, TILES):
            assert hdrs["x-cache"] in ("miss", "peer-hit")
        health = await fleet[0].health()
        if chaos == "dead_member":
            breakers = health["breakers"]
            assert any(k.startswith("cache:peer:") for k in breakers)
        else:
            assert health["breakers"]["cache:l2"]["state"] in ("open", "closed")
            assert health["result_cache"]["plane"]["l2"]["breaker"] == \
                health["breakers"]["cache:l2"]["state"]
    finally:
        fleet.stub.fail_mode = None
        await fleet.close()


async def test_mixed_fleet_renders_once_with_identical_bytes(tmp_path):
    """One JAX and one port replica on one ring and one stub: each key
    renders once fleet-wide and both answer identical bytes and ETags;
    hops signed over a percent-escaped /render query pass in both
    directions; a purge from either side reaches the other."""
    fleet = await _fleet(tmp_path, ["port", "jax"], cluster={"replication-factor": 2})
    port_r, jax_r = fleet[0], fleet[1]
    try:
        for i, path in enumerate(TILES):
            first, second = (port_r, jax_r) if i % 2 else (jax_r, port_r)
            one, two = await first.get(path), await second.get(path)
            assert one[0] == two[0] == 200 and one[2] == two[2]
            assert one[1]["etag"] == two[1]["etag"]
        await fleet.settle()
        assert sum(fleet.renders()) == len(TILES)
        # cold render keys, the first request alternating sides, until each
        # side has asked the other's owner twice (ownership is the ring's:
        # a side that owns its key renders it)
        hops = {"port": 0, "jax": 0}
        renders = 0
        while min(hops.values()) < 2:
            assert renders < 64, hops
            path = (f"/render/1/0/0/0?c=1%7C0:{60000 - 100 * renders}%24FF0000"
                    f"&x={64 * (renders % 4)}&y=0&w=64&h=64")
            first, second = (port_r, jax_r) if renders % 2 else (jax_r, port_r)
            one = await first.get(path)
            two = await second.get(path)
            assert one[0] == two[0] == 200 and one[2] == two[2], path
            if one[1]["x-cache"] == "peer-hit":
                hops[first.kind] += 1
            renders += 1
        await fleet.settle()
        assert sum(fleet.renders()) == len(TILES) + renders  # no double render
        # a purge from the port side reaches the JAX replica, and back
        port_r.app._invalidate_image(1)
        await _poll(lambda: jax_r.plane.epochs.known(1) == 1, "port -> jax purge")
        jax_r.app._invalidate_image(1)
        await _poll(lambda: port_r.plane.epochs.known(1) == 2, "jax -> port purge")
        for path in TILES[:4]:
            status, hdrs, _ = await port_r.get(path)
            assert status == 200 and hdrs["x-cache"] in ("miss", "peer-hit")
    finally:
        await fleet.close()


async def test_gossip_route_and_body_bound(tmp_path):
    """``/internal/gossip`` answers as the JAX app does: 403 without the
    marker, 400 on a bad digest, the replica's own digest with gossip on
    (the sender adopted into it) and 503 without; the plane raises the
    body bound to the transfer bound, and without the plane the front
    keeps its 1 MiB."""
    for cluster in (GOSSIP, None):
        fleet = await _fleet(tmp_path, ["port", "jax"], secret=None, cluster=cluster)
        try:
            for r in fleet.replicas:
                got = []
                for headers, body in (({}, b"{}"), ({"X-OMPB-Peer": "x"}, b"[]"),
                                      ({"X-OMPB-Peer": "x"}, b'{"from": "http://z:1"}')):
                    status, _, text = await _request(r.port, "POST", "/internal/gossip",
                                                     headers, body)
                    got.append((status, text))
                assert got[:2] == [(403, b"peer requests only"), (400, b"bad digest")]
                if cluster is None:
                    assert got[2] == (503, b"gossip disabled")
                else:
                    reply = json.loads(got[2][1])
                    assert got[2][0] == 200 and reply["from"] == r.url
                    assert "http://z:1" in reply["members"]
            assert fleet[0].app.max_body == (32 << 20) + 65536
        finally:
            await fleet.close()
    plain = wire(Config.from_dict({"session-store": {"type": "memory"}}), device="cpu")
    try:
        assert plain.max_body == 1 << 20 and plain.cache_plane is None
        assert plain.health()["cluster"] == {"enabled": False}
    finally:
        plain.pipeline.close()


# -- dynamic membership: gossip and leases ------------------------------------------

GOSSIP = {"gossip": {"enabled": True, "interval-s": 0.1, "fanout": 2, "fail-after-s": 3.0}}


def _urls(ports):
    return [f"http://127.0.0.1:{p}" for p in ports]


async def _converged(replicas, urls, what, timeout=20.0):
    await _poll(lambda: all(set(r.plane.membership.members) == set(urls) for r in replicas),
                what, timeout)


async def test_gossip_fleet_converges_renders_once_and_detects_a_crash(tmp_path):
    """Three port replicas over gossip (A and B seeded with each other, C
    with A alone) converge on one view; each key renders once fleet-wide;
    a replica that dies leaves the survivors' views no sooner than
    ``fail-after-s`` after its last heartbeat, and each key it owned
    renders at most once more, with the bytes it had."""
    ports = [_free_port() for _ in range(3)]
    a, b, c = urls = _urls(ports)
    replicas = []
    try:
        for port, seed in zip(ports, ([a, b], [a, b], [a, c])):
            replicas.append(await _replica(tmp_path, "port", port, seed, None, SECRET, GOSSIP))
        await _converged(replicas, urls, "the gossip views did not converge")
        bodies = {}
        for i, path in enumerate(TILES):
            for r in (replicas[i % 3], replicas[(i + 1) % 3]):
                status, _, body = await r.get(path)
                assert status == 200 and bodies.setdefault(path, body) == body
        renders = [r.renders() for r in replicas]
        assert sum(renders) == len(TILES)  # render-once across the fleet
        heard = [r.plane.membership._heard[b] for r in (replicas[0], replicas[2])]
        await replicas[1].close()
        survivors = [replicas[0], replicas[2]]
        await _converged(survivors, [a, c], "the crash was not detected", timeout=30.0)
        now = [r.plane.membership._clock() for r in survivors]
        assert all(t - h > 3.0 for t, h in zip(now, heard))  # not before fail-after-s
        assert all(e["event"] == "leave" for e in (
            r.plane.membership.snapshot()["events"][-1] for r in survivors))
        for r in survivors:
            for path in TILES:
                status, _, body = await r.get(path)
                assert status == 200 and body == bodies[path]
        # B's keys render once more at most (a survivor that fetched one
        # from B already holds it), never twice
        after = [r.renders() for r in survivors]
        assert 0 <= sum(after) - (renders[0] + renders[2]) <= renders[1]
        for r in survivors:
            for path in TILES:
                await r.get(path)
        assert [r.renders() for r in survivors] == after
    finally:
        for r in replicas:
            if r.kind == "port" and r.app._server is not None:
                await r.close()


async def test_lease_fleet_join_drain_and_leave(tmp_path):
    """Port replicas on leases in the RESP stub: a joiner seeded with
    itself alone enters every view within a few heartbeats; a drain
    publishes its marker (every peer sees it draining, still a member, no
    owner) and then deletes its lease, and it leaves every view."""
    stub = InMemoryRespServer()
    await stub.start()
    ports = [_free_port() for _ in range(3)]
    a, b, c = urls = _urls(ports)
    lease = {"lease-ttl-s": 0.9}
    replicas = []
    try:
        for port, url in zip(ports[:2], urls[:2]):
            replicas.append(await _replica(tmp_path, "port", port, [url], stub, SECRET, lease))
        await _converged(replicas, [a, b], "the leases did not meet")
        replicas.append(await _replica(tmp_path, "port", ports[2], [c], stub, SECRET, lease))
        await _converged(replicas, urls, "the joiner did not enter every view")
        assert sorted(k for k in stub.data if k.startswith(b"ompb:cluster:member:")) == sorted(
            f"ompb:cluster:member:{u}".encode() for u in urls)
        target = "/internal/drain"
        status, _, _ = await _request(ports[2], "POST", target, _signed("POST", target, a))
        assert status == 200
        others = replicas[:2]
        await _poll(lambda: all(c in r.plane.membership.draining for r in others),
                    "the drain marker was not seen")
        assert all(c in r.plane.membership.members for r in others)
        assert all(c not in r.plane._ring_eligible() for r in others)
        await _converged(others, [a, b], "the drained replica did not leave")
        assert f"ompb:cluster:member:{c}".encode() not in stub.data
        for r in others:
            events = [(e["event"], e["url"]) for e in r.plane.membership.snapshot()["events"]]
            assert events[-2:] == [("drain", c), ("leave", c)]
        assert replicas[2].plane.membership.released
    finally:
        for r in replicas:
            await r.close()
        await stub.close()


async def test_mixed_gossip_fleet_joins_and_warms_up_both_ways(tmp_path):
    """A JAX and a port replica gossip with each other and render each key
    once with identical bytes. A port joiner seeded with the JAX replica
    warms up from it (a port pull of JAX transfers); a JAX joiner seeded
    with that port joiner warms up from the port replicas (a JAX pull of
    port transfers); an out-of-seed port joiner enters the fleet through
    one signed hop. Every view converges and the joiners serve the warmed
    entries byte-equal."""
    ports = [_free_port() for _ in range(5)]
    a, b, c, d, e = urls = _urls(ports)
    gossip = {**GOSSIP, "replication-factor": 2}
    replicas = []
    served = {}

    def count(rep):
        plane = rep.plane
        inner = plane.hot_transfer_payload

        def payload(limit):
            served[rep.url] = served.get(rep.url, 0) + 1
            return inner(limit)

        plane.hot_transfer_payload = payload

    try:
        replicas.append(await _replica(tmp_path, "jax", ports[0], [a, b], None, SECRET, gossip))
        replicas.append(await _replica(tmp_path, "port", ports[1], [a, b], None, SECRET,
                                       gossip))
        await _converged(replicas, [a, b], "jax + port did not converge")
        bodies = {}
        for i, path in enumerate(TILES):
            one = await replicas[i % 2].get(path)
            two = await replicas[(i + 1) % 2].get(path)
            assert one[0] == two[0] == 200 and one[2] == two[2]
            assert one[1]["etag"] == two[1]["etag"]
            bodies[path] = one[2]
        assert sum(r.renders() for r in replicas) == len(TILES)
        for rep in replicas:
            count(rep)
        # a port joiner seeded with the JAX replica pulls its hot set
        replicas.append(await _replica(tmp_path, "port", ports[2], [c, a], None, SECRET,
                                       gossip))
        count(replicas[2])
        await _converged(replicas, [a, b, c], "the port joiner did not converge")
        await _poll(lambda: replicas[2].plane.replicator.transfers_pulled == 1,
                    "the port joiner did not warm up")
        assert served.get(a, 0) >= 1  # from the JAX owner
        # a JAX joiner seeded with the port joiner pulls from port owners
        replicas.append(await _replica(tmp_path, "jax", ports[3], [d, c], None, SECRET, gossip))
        await _converged(replicas, [a, b, c, d], "the JAX joiner did not converge")
        await _poll(lambda: replicas[3].plane.replicator.transfers_pulled == 1,
                    "the JAX joiner did not warm up")
        assert served.get(b, 0) >= 1 and served.get(c, 0) >= 1
        before = [r.renders() for r in replicas]
        for joiner in replicas[2:4]:
            for path in TILES:
                status, hdrs, body = await joiner.get(path)
                assert status == 200 and body == bodies[path], (joiner.kind, path)
        assert sum(r.renders() for r in replicas) == sum(before)  # warm: nothing re-rendered
        # an out-of-seed port joiner: one signed hop (as e) teaches the
        # JAX replica its address; gossip does the rest
        replicas.append(await _replica(tmp_path, "port", ports[4], [e], None, SECRET, gossip))
        target = "/internal/digest?limit=1"
        status, _, _ = await _request(ports[0], "GET", target, _signed("GET", target, e))
        assert status == 200
        await _converged(replicas, urls, "the out-of-seed joiner did not converge")
        assert replicas[0].plane.membership.contacts_adopted >= 1
    finally:
        for r in replicas:
            await r.close()


async def test_gossip_replies_match_jax_bytes(tmp_path, monkeypatch):
    """One replica of each package on the same port, with gossip on and
    one dead seed, after its first round: the same signed digest POSTed
    to ``/internal/gossip`` gets byte-equal replies (members, heartbeats,
    the piggybacked brain), and both adopt the sender."""
    from omero_ms_pixel_buffer_tpu.cluster import brains as jbrains
    from omero_ms_pixel_buffer_tpu_torch.cluster import brains as pbrains

    monkeypatch.setattr(jbrains, "time", _Clock)
    monkeypatch.setattr(pbrains, "time", _Clock)
    port, dead = _free_port(), _free_port()
    me, sender = f"http://127.0.0.1:{port}", f"http://127.0.0.1:{dead}"
    cluster = {"gossip": {"enabled": True, "interval-s": 60, "fail-after-s": 120}}
    digest = json.dumps({"v": 1, "from": sender, "members": {
        sender: {"hb": 7, "draining": False, "left": False},
        me: {"hb": 3, "draining": False, "left": False},
        "http://10.0.0.9:1": {"hb": 2, "draining": True, "left": False}}},
        separators=(",", ":")).encode()
    replies = {}
    for kind in ("jax", "port"):
        rep = await _replica(tmp_path, kind, port, [me, sender], None, SECRET, cluster)
        try:
            await _poll(lambda: rep.plane.membership.refreshes >= 1, "no first round")
            status, hdrs, body = await _request(
                port, "POST", "/internal/gossip",
                _signed("POST", "/internal/gossip", sender, digest,
                        **{"Content-Type": "application/json"}), digest)
            replies[kind] = (status, hdrs.get("content-type"), body,
                             rep.plane.membership.members)
        finally:
            await rep.close()
        pbreaker.BOARD.reset()
        JAX_BOARD.reset()
    assert replies["port"] == replies["jax"]
    status, ctype, body, members = replies["port"]
    assert status == 200 and ctype == "application/json; charset=utf-8"
    reply = json.loads(body)
    assert reply["from"] == me and reply["members"][me]["hb"] == 4  # refuted past 3
    assert set(members) == {me, sender, "http://10.0.0.9:1"}
