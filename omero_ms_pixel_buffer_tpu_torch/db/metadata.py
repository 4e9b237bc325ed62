"""OMERO Postgres metadata resolver (a copy of
``omero_ms_pixel_buffer_tpu/db/metadata.py``, the PyTorch port's own: it
imports nothing of the JAX package).

The reference resolves tile metadata with an HQL query against the
OMERO server — ``Pixels`` joined with its image and pixels type, with
``omero.group = -1`` for a cross-group read, null when the image does
not exist (TileRequestHandler.java:220-241). This resolver implements
the same contract directly against the OMERO database over the in-tree
wire client (db/postgres.py): one round trip, one row, `None` -> 404.

Wiring: this covers the *metadata plane* only. The serving path also
needs the *buffer plane* (imageId -> storage path/reader), which the
filesystem ``ImageRegistry`` provides; a deployment against a live
OMERO database combines the two — registry (or OMERO data-dir layout)
for paths, this resolver for authoritative dimensions/type. Construct
with the ``omero.server.*`` database DSN (config.yaml's
``omero.server`` block carries the database settings in a real
deployment).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import threading
import time
from typing import Callable, List, Optional

from ..io.pixel_buffer import PixelsMeta
from ..resilience.deadline import DeadlineExceeded, current_deadline
from .postgres import PostgresClient

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.db.metadata")


class _LoopThread:
    """A persistent background event loop so the sync adapter reuses
    one connection instead of paying TCP + SCRAM per call (and never
    leaks sockets to closed throwaway loops)."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self.loop.run_forever, name="pg-metadata", daemon=True
        )
        self._thread.start()

    def run(self, coro, timeout: float = 30.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout
        )

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)
        self.loop.close()

# The HQL join, flattened to SQL over the OMERO schema: pixels rows
# carry dimensions + FK to pixelstype (enum value = "uint16" etc.) and
# to their image (name, format, externalInfo — the reference's LEFT
# OUTER JOIN FETCHes) plus the ACL columns (owner/group/permissions)
# that let the resolver apply the permission filtering the reference
# gets for free by running inside the caller's session.
# Mirrors TileRequestHandler.java:220-241.
PIXELS_QUERY = (
    "SELECT p.id, p.sizex, p.sizey, p.sizez, p.sizec, p.sizet, "
    "pt.value, i.name, i.owner_id, i.group_id, g.permissions, "
    "f.value, e.entitytype, e.lsid, e.uuid "
    "FROM pixels p "
    "JOIN image i ON p.image = i.id "
    "JOIN pixelstype pt ON p.pixelstype = pt.id "
    "LEFT JOIN experimentergroup g ON i.group_id = g.id "
    "LEFT JOIN format f ON i.format = f.id "
    "LEFT JOIN externalinfo e ON i.external_id = e.id "
    "WHERE i.id = $1"
)

# The caller's identity: an OMERO session key is the `session` row's
# uuid; a closed session (closed timestamp set) no longer reads
# anything — the analog of the reference's per-request session join
# (PixelBufferVerticle.java:106-110) going stale.
SESSION_USER_QUERY = (
    "SELECT s.owner FROM session s "
    "WHERE s.uuid = $1 AND s.closed IS NULL"
)

# Group memberships (m.owner marks a group LEADER, who reads all group
# data) + group names ('system' membership = full admin).
USER_GROUPS_QUERY = (
    "SELECT m.parent, m.owner, g.name "
    "FROM groupexperimentermap m "
    "JOIN experimentergroup g ON m.parent = g.id "
    "WHERE m.child = $1"
)

# OMERO permission bits (ome.model.internal.Permissions): the bigint
# is all-ones with DENIED rights cleared; rights live in per-role
# nibbles shifted USER=8 / GROUP=4 / WORLD=0, read = the nibble's low
# bit. Derivation pinned by the four canonical group-permission longs:
#   -120 'rw----' private        -> group/world nibbles cleared
#   -104 'rwr---' read-only      -> +bit 4  (GROUP_READ)
#    -72 'rwra--' read-annotate  -> +bit 5  (group annotate)
#    -40 'rwrw--' read-write     -> +bit 6  (group write)
USER_READ = 1 << 8
GROUP_READ = 1 << 4
WORLD_READ = 1 << 0
# Write rights live two bits above read in each role nibble (the
# canonical longs above: -40 'rwrw--' sets bit 6, group write).
USER_WRITE = 1 << 10
GROUP_WRITE = 1 << 6
WORLD_WRITE = 1 << 2
_PRIVATE = -120  # default when the group row is missing


def can_read(
    user_ctx: Optional[tuple], owner_id: Optional[int],
    group_id: Optional[int], permissions: int,
) -> bool:
    """OMERO's read rule for one object, evaluated host-side.

    ``user_ctx`` is (user_id, {group_id: is_leader}, is_admin) or None
    for an unknown/closed session (reads nothing). Mirrors the server's
    security filter: admins read everything; group leaders read their
    whole group; owners read their data (USER_READ); members read
    group-readable data (GROUP_READ); WORLD_READ is public.

    Known over-grant: ``is_admin`` is derived from
    'system'-group membership alone. OMERO 5.4+ *restricted* ("light")
    admins are system-group members whose AdminPrivilege set may NOT
    include data-read rights ("ReadSession"/sudo-style privileges
    only); the server's security filter would deny them, this
    short-circuit grants them. Closing it means joining
    ``adminprivilege`` and short-circuiting only for unrestricted
    admins; until then, deployments with restricted admins should
    treat this resolver's admin reads as broader than the server's."""
    if user_ctx is None:
        return False
    user_id, groups, is_admin = user_ctx
    if is_admin:
        return True
    if group_id in groups and groups[group_id]:
        return True  # group leader
    if owner_id == user_id and permissions & USER_READ:
        return True
    if group_id in groups and permissions & GROUP_READ:
        return True
    return bool(permissions & WORLD_READ)


def can_write(
    user_ctx: Optional[tuple], owner_id: Optional[int],
    group_id: Optional[int], permissions: int,
) -> bool:
    """OMERO's write rule for one object (the ingest plane's ACL):
    admins and group leaders write anything in scope; owners write
    their own data (USER_WRITE — set in every canonical permission
    long); members need GROUP_WRITE ('rwrw--', -40); WORLD_WRITE is
    never set by stock OMERO but evaluated for completeness. Shares
    the restricted-admin over-grant documented on ``can_read``."""
    if user_ctx is None:
        return False
    user_id, groups, is_admin = user_ctx
    if is_admin:
        return True
    if group_id in groups and groups[group_id]:
        return True  # group leader
    if owner_id == user_id and permissions & USER_WRITE:
        return True
    if group_id in groups and permissions & GROUP_WRITE:
        return True
    return bool(permissions & WORLD_WRITE)


class OmeroPostgresMetadataResolver:
    """MetadataResolver over the OMERO database (async core with a sync
    adapter for the pipeline's synchronous resolve stage).

    With ``enforce_permissions`` on, ``get_pixels`` applies OMERO's
    read ACL for the caller's session before returning metadata — the
    behavior the reference gets by executing its HQL inside the joined
    session (TileRequestHandler.java:220-241): an image the user cannot
    read resolves to None, hence 404, exactly like one that does not
    exist. The caller's identity re-resolves from the ``session`` table
    every ``session_cache_ttl_s`` (a destroyed session stops reading
    within that bound)."""

    def __init__(self, uri: str, cache_ttl_s: float = 60.0,
                 cache_max: int = 4096,
                 enforce_permissions: bool = False,
                 session_cache_ttl_s: float = 10.0):
        self._client = PostgresClient.from_uri(uri)
        self._runner: Optional[_LoopThread] = None
        self._runner_lock = threading.Lock()
        self._closed = False
        self.enforce_permissions = enforce_permissions
        # Per-image TTL cache: metadata is effectively immutable for a
        # stored image, so the hot path must not pay one DB roundtrip
        # per tile (the registry path it replaces answers from memory).
        # Entries carry (meta, owner_id, group_id, permissions); the
        # ACL verdict is evaluated per caller, never cached with the row.
        self._cache_ttl_s = cache_ttl_s
        self._cache_max = cache_max
        self._cache: dict = {}  # image_id -> (expires_at, row)
        self._cache_lock = threading.Lock()
        self._session_cache_ttl_s = session_cache_ttl_s
        self._sessions: dict = {}  # key -> (expires_at, user_ctx|None)
        # invalidation listeners: fired with the image id whenever a
        # TTL refresh observes the pixels row CHANGED (dimensions,
        # type, ownership, permissions) or GONE — the cache layer
        # (cache/ package, http/server) purges rendered tiles, open
        # buffers, and device planes for the image in response
        self._listeners: List[Callable[[int], None]] = []

    def add_invalidation_listener(
        self, fn: Callable[[int], None]
    ) -> None:
        """Register ``fn(image_id)`` to run when this resolver observes
        a changed/deleted pixels row. Listeners fire on whatever
        thread refreshed the row (usually the resolver's background
        loop) and must be thread-safe and non-blocking; exceptions are
        logged and isolated."""
        self._listeners.append(fn)

    def _notify_invalidated(self, image_id: int) -> None:
        for fn in list(self._listeners):
            try:
                fn(image_id)
            except Exception:
                log.exception(
                    "invalidation listener failed for image %s", image_id
                )

    @staticmethod
    def _row_signature(row) -> tuple:
        """The change-detection fingerprint of one pixels row: any
        difference here means cached tiles rendered from the old row
        may be stale (or newly unauthorized)."""
        meta, owner_id, group_id, perms = row
        return (
            meta.size_x, meta.size_y, meta.size_z, meta.size_c,
            meta.size_t, meta.pixels_type, meta.image_name,
            owner_id, group_id, perms,
        )

    def _cache_get(self, cache: dict, key):
        with self._cache_lock:
            hit = cache.get(key)
            if hit is not None and hit[0] > time.monotonic():
                return True, hit[1]
        return False, None

    def _cache_put(self, cache: dict, key, value, ttl_s: float) -> None:
        with self._cache_lock:
            if len(cache) >= self._cache_max:
                # evict the oldest-inserted tenth, NOT everything:
                # pixels rows double as the invalidation-detection
                # baselines (_pixels_row compares the stale entry
                # against the refresh), and a wholesale clear would
                # silently disarm change detection for every image at
                # once
                for stale_key in list(cache)[
                    : max(1, self._cache_max // 10)
                ]:
                    del cache[stale_key]
            cache[key] = (time.monotonic() + ttl_s, value)

    def _cache_peek_stale(self, cache: dict, key):
        """The entry's value even when EXPIRED (the change-detection
        baseline at refresh time); None when absent."""
        with self._cache_lock:
            hit = cache.get(key)
        return None if hit is None else hit[1]

    def _cache_pop(self, cache: dict, key) -> None:
        with self._cache_lock:
            cache.pop(key, None)

    async def _pixels_row(self, image_id: int):
        """(meta, owner_id, group_id, permissions) or None, TTL-cached."""
        cached, row = self._cache_get(self._cache, image_id)
        if cached:
            return row
        # the expired (or absent) previous row is the change-detection
        # baseline: a refresh that reads something DIFFERENT fires the
        # invalidation listeners
        prev_row = self._cache_peek_stale(self._cache, image_id)
        rows = await self._client.query(PIXELS_QUERY, [str(image_id)])
        if not rows:
            if prev_row is not None:
                # the image vanished (deleted mid-serving): purge our
                # own stale row and everything cached downstream
                self._cache_pop(self._cache, image_id)
                self._notify_invalidated(image_id)
            # no negative caching: an image mid-import must become
            # visible on the next request, not after a TTL of 404s
            return None  # -> 404 "Cannot find Image:<id>"
        (_pid, sx, sy, sz, sc, st, ptype, name,
         owner_id, group_id, perms, fmt, e_type, e_lsid, e_uuid) = rows[0]
        external = None
        if e_type is not None or e_lsid is not None or e_uuid is not None:
            external = {"entityType": e_type, "lsid": e_lsid,
                        "uuid": e_uuid}
        meta = PixelsMeta(
            image_id=image_id,
            size_x=int(sx), size_y=int(sy),
            size_z=int(sz), size_c=int(sc), size_t=int(st),
            pixels_type=ptype,
            image_name=name or str(image_id),
            image_format=fmt,
            external_info=external,
        )
        row = (
            meta,
            int(owner_id) if owner_id is not None else None,
            int(group_id) if group_id is not None else None,
            int(perms) if perms is not None else _PRIVATE,
        )
        if prev_row is not None and self._row_signature(
            prev_row
        ) != self._row_signature(row):
            log.info("pixels row changed for image %s; invalidating",
                     image_id)
            self._notify_invalidated(image_id)
        self._cache_put(self._cache, image_id, row, self._cache_ttl_s)
        return row

    def invalidate(self, image_id: int) -> None:
        """Operational hook: forget the cached row NOW and fire the
        listeners (e.g. an import pipeline that knows it just rewrote
        the image, without waiting out the TTL)."""
        image_id = int(image_id)
        self._cache_pop(self._cache, image_id)
        self._notify_invalidated(image_id)

    async def _session_context(self, session_key):
        """(user_id, {group_id: is_leader}, is_admin) for a LIVE
        session, None for unknown/closed/absent keys; cached for
        ``session_cache_ttl_s`` (the revocation bound)."""
        if not session_key:
            return None
        cached, ctx = self._cache_get(self._sessions, session_key)
        if cached:
            return ctx
        ctx = None
        rows = await self._client.query(
            SESSION_USER_QUERY, [session_key]
        )
        if rows:
            user_id = int(rows[0][0])
            groups: dict = {}
            is_admin = False
            for gid, leader, gname in await self._client.query(
                USER_GROUPS_QUERY, [str(user_id)]
            ):
                is_leader = str(leader).lower() in ("t", "true", "1")
                groups[int(gid)] = is_leader
                if gname == "system":
                    is_admin = True
            ctx = (user_id, groups, is_admin)
        self._cache_put(
            self._sessions, session_key, ctx, self._session_cache_ttl_s
        )
        return ctx

    async def get_pixels_async(
        self, image_id: int, session_key: Optional[str] = None
    ) -> Optional[PixelsMeta]:
        image_id = int(image_id)
        row = await self._pixels_row(image_id)
        if row is None:
            return None
        meta, owner_id, group_id, perms = row
        if self.enforce_permissions:
            ctx = await self._session_context(session_key)
            if not can_read(ctx, owner_id, group_id, perms):
                # unauthorized reads exactly like nonexistent — the
                # reference's session-scoped HQL returns null for both
                return None
        return meta

    def _run(self, coro, default_timeout_s: float = 30.0):
        with self._runner_lock:
            if self._closed:
                coro.close()
                raise RuntimeError("metadata resolver is closed")
            if self._runner is None:
                self._runner = _LoopThread()
            runner = self._runner
        # the sync adapter's wait is bounded by the ambient request
        # deadline (resilience/deadline): a wedged Postgres costs the
        # caller at most its budget — the worker thread unblocks and
        # the request answers 504; the coroutine finishes (or fails)
        # in the background on the resolver's own loop
        deadline = current_deadline()
        timeout = (
            default_timeout_s if deadline is None
            else max(0.01, deadline.cap(default_timeout_s))
        )
        try:
            return runner.run(coro, timeout=timeout)
        except concurrent.futures.TimeoutError:
            if deadline is not None and deadline.expired:
                raise DeadlineExceeded("postgres query") from None
            raise

    def get_pixels(
        self, image_id: int, session_key: Optional[str] = None
    ) -> Optional[PixelsMeta]:
        """Sync adapter (the MetadataResolver surface): dispatches onto
        a persistent background loop, so the connection — and its
        SCRAM handshake — is reused across calls. Callers already on
        an event loop should use ``get_pixels_async`` directly."""
        cached, row = self._cache_get(self._cache, int(image_id))
        if cached and row is not None:
            meta, owner_id, group_id, perms = row
            if not self.enforce_permissions:
                return meta
            ctx_cached, ctx = self._cache_get(
                self._sessions, session_key
            )
            if ctx_cached:
                return (
                    meta if can_read(ctx, owner_id, group_id, perms)
                    else None
                )
        return self._run(self.get_pixels_async(image_id, session_key))

    async def can_write_image_async(
        self, image_id: int, session_key: Optional[str]
    ) -> bool:
        """Whether the caller's session may WRITE the image's pixels
        (the ingest plane's permission check). An unknown image is
        False — the handler 404s before this is consulted, but the
        check must fail closed either way. Without
        ``enforce_permissions`` any authenticated session writes
        (matching the read posture)."""
        row = await self._pixels_row(int(image_id))
        if row is None:
            return False
        if not self.enforce_permissions:
            return True
        _meta, owner_id, group_id, perms = row
        ctx = await self._session_context(session_key)
        return can_write(ctx, owner_id, group_id, perms)

    def can_write_image(
        self, image_id: int, session_key: Optional[str]
    ) -> bool:
        """Sync adapter of ``can_write_image_async`` (same background
        loop as ``get_pixels``)."""
        return self._run(
            self.can_write_image_async(image_id, session_key)
        )

    def get_pixels_unchecked(
        self, image_id: int
    ) -> Optional[PixelsMeta]:
        """Metadata row WITHOUT ACL evaluation — for the buffer plane's
        internal dimension lookups (e.g. a ROMIO plane file carries no
        header). On the serving path authorization already happened at
        resolve time; never expose this to request-derived calls."""
        image_id = int(image_id)
        cached, row = self._cache_get(self._cache, image_id)
        if not cached:
            row = self._run(self._pixels_row(image_id))
        return None if row is None else row[0]

    def query(self, sql: str, params: list) -> list:
        """Run an arbitrary parameterized query on the shared
        connection/loop (sync). The file-path resolver (db/resolver.py)
        rides this so one SCRAM'd connection serves both the metadata
        and the path plane."""
        return self._run(self._client.query(sql, params))

    async def close(self) -> None:
        await self._client.close()

    def close_sync(self) -> None:
        with self._runner_lock:
            self._closed = True
            runner, self._runner = self._runner, None
        if runner is not None:
            runner.run(self._client.close())
            runner.close()
