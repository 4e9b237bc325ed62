"""The batched read plane (counterpart of ``omero_ms_pixel_buffer_tpu/io/
fetch.py``): the shared connection pool, ranged GETs and the coalescing
parallel fetch planner that the stores (``io/stores.py``) and the Zarr
reader (``io/zarr.py``) use.

- ``FetchPool``: one process-wide keep-alive pool, at most
  ``max_per_host`` connections per (scheme, host), shared by every
  thread; the per-host bound is the concurrency ceiling of the parallel
  fan-out against one origin.
- ``resilient_get``: the breaker and jittered-retry wrapper every store
  GET runs under (``resilience/``).
- ``fetch_many``: dedupe identical requests, coalesce adjacent ranges of
  one key within ``coalesce_gap_bytes`` into one ranged GET (sliced
  apart afterwards), fan the planned requests out on a bounded executor,
  and degrade a failed planned request to one whole-key GET. An open
  breaker (``StoreUnavailableError``) never falls back.

The knobs are module values at the JAX package's ``io:`` defaults
(parallel fetch on); ``configure`` applies the YAML ``io:`` block before
the first read (``io.parallel-fetch: false``, ``PARALLEL``, restores the
strictly sequential chunk walk of ``io/zarr.py``). ``io_fetch_seconds``
(one planned batch, its exemplar deferred to the flight record),
``io_requests_per_tile`` and ``io_coalesced_ratio`` go to ``/metrics``
under the JAX names. ``io_snapshot()`` is the
``/healthz`` ``io`` view: the JAX package's counters, plus the tiles read
through the planner (store requests per tile) and the chunks decoded.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import http.client
import threading
import time
import urllib.parse
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs.recorder import defer_exemplar
from ..resilience.breaker import BreakerOpenError, CircuitBreaker
from ..utils.metrics import REGISTRY
from .pixel_buffer import NEGATIVE_TTL_S
from ..resilience.deadline import DeadlineExceeded, current_deadline
from ..resilience.faultinject import INJECTOR
from ..resilience.retry import retry_call

_RETRY_STATUSES = (500, 502, 503, 504)

IO_FETCH_SECONDS = REGISTRY.histogram(
    "io_fetch_seconds",
    "Wall time of one planned batch fetch (get_many call)",
)
# the JAX buckets, which end at 32.0: the +Inf bucket that utils/metrics
# appends counts a tile of more requests
IO_REQUESTS_PER_TILE = REGISTRY.histogram(
    "io_requests_per_tile",
    "Store requests issued per tile in a batched read",
    buckets=(0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0),
)


class StoreError(IOError):
    """A store failure that is not a missing key (auth, transport, 5xx):
    never read as fill_value."""


class StoreUnavailableError(StoreError):
    """The store's circuit breaker is open: the GET was rejected without
    touching the network. ``retry_after_s`` says when the next half-open
    probe will be admitted (the lane answers 503 with ``Retry-After``)."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class _TransientStatus(Exception):
    """Carries a retryable HTTP status (5xx) through the retry helper."""

    def __init__(self, status: int, body: bytes):
        super().__init__(f"HTTP {status}")
        self.status = status
        self.body = body


PARALLEL = True                # plan, coalesce and prefetch a batch's chunks
FETCH_WORKERS = 16             # threads fanning planned requests out
MAX_CONNS_PER_HOST = 8         # the pool's per-host bound
COALESCE_GAP_BYTES = 64 << 10  # ranges of one key closer than this merge
DECODE_WORKERS = 4             # threads decoding a batch's chunks
# the knobs as the JAX ``io`` view spells them
_CONFIG_VIEW = {"parallel": True, "fetch_workers": FETCH_WORKERS,
                "max_conns_per_host": MAX_CONNS_PER_HOST,
                "coalesce_gap_kb": COALESCE_GAP_BYTES >> 10,
                "decode_workers": DECODE_WORKERS, "negative_ttl_s": NEGATIVE_TTL_S}

# one coalesced request never spans more than this (gap bytes are
# fetched and thrown away)
_MAX_COALESCED_BYTES = 32 << 20


class FetchStats:
    """Thread-safe read-plane counters: one process-wide instance
    (``IO_STATS``) and one per batched read, so a read can count its own
    store requests without racing other batches."""

    __slots__ = (
        "_lock", "planned", "issued", "ranged", "coalesced_saved",
        "bytes_fetched", "bytes_discarded", "fallbacks", "batches",
        "tiles", "decodes",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self.planned = 0          # logical (pre-coalesce) requests
        self.issued = 0           # store requests actually issued
        self.ranged = 0           # of those, ranged GETs
        self.coalesced_saved = 0  # requests avoided by range merging
        self.bytes_fetched = 0
        self.bytes_discarded = 0  # coalescing gap bytes thrown away
        self.fallbacks = 0        # planned requests degraded to get()
        self.batches = 0          # fetch_many calls
        self.tiles = 0            # tiles of the batched reads that planned
        self.decodes = 0          # chunks decoded by the Zarr reader

    def add(self, **deltas) -> None:
        with self._lock:
            for k, v in deltas.items():
                setattr(self, k, getattr(self, k) + v)

    def snapshot(self) -> dict:
        with self._lock:
            planned = self.planned
            saved = self.coalesced_saved
            return {
                "planned": planned,
                "issued": self.issued,
                "ranged": self.ranged,
                "coalesced_saved": saved,
                "coalesced_ratio": round(saved / planned, 4) if planned else 0.0,
                "bytes_fetched": self.bytes_fetched,
                "bytes_discarded": self.bytes_discarded,
                "fallbacks": self.fallbacks,
                "batches": self.batches,
                "tiles": self.tiles,
                "requests_per_tile": (
                    round(self.issued / self.tiles, 4) if self.tiles else None),
                "decodes": self.decodes,
            }


IO_STATS = FetchStats()

REGISTRY.gauge_fn(
    "io_coalesced_ratio",
    "Fraction of planned store requests avoided by range coalescing",
    lambda: IO_STATS.snapshot()["coalesced_ratio"],
)


def configure(io_config) -> None:
    """Apply a validated ``io:`` block (``utils.config.IoConfig``)
    process-wide: the fetch and decode pools' sizes (before their first
    use), the per-host connection bound, the coalescing gap, and the TTLs
    of absent chunks and of memoized shard indexes."""
    global PARALLEL, FETCH_WORKERS, MAX_CONNS_PER_HOST, COALESCE_GAP_BYTES, DECODE_WORKERS
    from . import pixel_buffer, zarr

    PARALLEL = bool(io_config.parallel_fetch)
    FETCH_WORKERS = int(io_config.fetch_workers)
    MAX_CONNS_PER_HOST = int(io_config.max_conns_per_host)
    COALESCE_GAP_BYTES = int(io_config.coalesce_gap_kb * 1024)
    DECODE_WORKERS = int(io_config.decode_workers)
    pixel_buffer.set_negative_ttl(io_config.negative_ttl_s)
    zarr.SHARD_INDEX_TTL_S = float(io_config.shard_index_ttl_s)
    POOL.set_max_per_host(MAX_CONNS_PER_HOST)
    _CONFIG_VIEW.update(parallel=PARALLEL, fetch_workers=FETCH_WORKERS,
                        max_conns_per_host=MAX_CONNS_PER_HOST,
                        coalesce_gap_kb=io_config.coalesce_gap_kb,
                        decode_workers=DECODE_WORKERS,
                        negative_ttl_s=pixel_buffer.NEGATIVE_TTL_S)


def io_snapshot() -> dict:
    """The ``/healthz`` ``io`` view: read-plane counters, pool state and
    the knobs."""
    snap = IO_STATS.snapshot()
    snap["pool"] = POOL.snapshot()
    snap["config"] = dict(_CONFIG_VIEW)
    return snap


class FetchPool:
    """Bounded shared per-host HTTP(S) keep-alive pool: at most
    ``max_per_host`` connections per (scheme, netloc) exist at once, idle
    ones are reused by whichever thread fetches next, and the per-host
    semaphore bounds the fan-out against one origin. A reused socket that
    the server closed while idle is retried once on a fresh one."""

    def __init__(self, max_per_host: int = 8):
        self._lock = threading.Lock()
        self._max_per_host = max_per_host
        self._idle: Dict[Tuple[str, str], list] = {}
        self._sems: Dict[Tuple[str, str], threading.BoundedSemaphore] = {}
        self._in_use: Dict[Tuple[str, str], int] = {}

    def set_max_per_host(self, n: int) -> None:
        """A new per-host bound; a host's semaphore is rebuilt only while
        none of its connections is checked out (start-up configuration:
        the serving path never resizes)."""
        with self._lock:
            self._max_per_host = max(1, int(n))
            for key in list(self._sems):
                if not self._in_use.get(key):
                    self._sems.pop(key)
                    for conn in self._idle.pop(key, []):
                        conn.close()

    def _sem(self, key) -> threading.BoundedSemaphore:
        with self._lock:
            sem = self._sems.get(key)
            if sem is None:
                sem = self._sems[key] = threading.BoundedSemaphore(self._max_per_host)
            return sem

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "max_per_host": self._max_per_host,
                "hosts": {
                    f"{scheme}://{netloc}": {
                        "idle": len(self._idle.get((scheme, netloc), [])),
                        "in_use": self._in_use.get((scheme, netloc), 0),
                    }
                    for scheme, netloc in self._sems
                },
            }

    def request(self, url: str, headers: dict, timeout_s: float, method: str = "GET",
                body: Optional[bytes] = None) -> Tuple[int, bytes]:
        """One request over a pooled connection: (status, body). The
        caller's ``resilient_get`` gates it through the store's breaker.
        ``method`` and ``body`` carry the ingest plane's writes (PUT,
        POST) over the same keep-alive sockets; a write is retried only
        when a reused socket died while idle, before the server saw it."""
        parsed = urllib.parse.urlsplit(url)
        key = (parsed.scheme, parsed.netloc)
        path = parsed.path or "/"
        if parsed.query:
            path += f"?{parsed.query}"
        sem = self._sem(key)
        if not sem.acquire(timeout=timeout_s):
            raise StoreError(f"fetch pool exhausted for {parsed.netloc} "
                             f"(waited {timeout_s:.1f}s for a connection)")
        try:
            for attempt in (0, 1):
                with self._lock:
                    idle = self._idle.get(key)
                    conn = idle.pop() if idle else None
                    self._in_use[key] = self._in_use.get(key, 0) + 1
                reused = conn is not None
                if conn is None:
                    cls = (http.client.HTTPSConnection if parsed.scheme == "https"
                           else http.client.HTTPConnection)
                    conn = cls(parsed.netloc, timeout=timeout_s)
                try:
                    conn.request(method, path, body=body, headers=headers)
                    resp = conn.getresponse()
                    data = resp.read()  # drain so the socket is reusable
                except (http.client.HTTPException, OSError) as e:
                    conn.close()
                    with self._lock:
                        self._in_use[key] -= 1
                    # retry only a reused socket the server closed while
                    # idle; a fresh connection's failure is an outage
                    if reused and attempt == 0:
                        continue
                    raise StoreError(f"{method} {url} failed: {e}") from None
                with self._lock:
                    self._in_use[key] -= 1
                    idle = self._idle.setdefault(key, [])
                    if len(idle) < self._max_per_host:
                        idle.append(conn)
                    else:
                        conn.close()
                return resp.status, data
            raise StoreError(f"{method} {url} failed")  # pragma: no cover
        finally:
            sem.release()


POOL = FetchPool(MAX_CONNS_PER_HOST)


def resilient_get(fn, breaker: CircuitBreaker, name: str = "",
                  point: Optional[str] = None) -> Tuple[int, bytes]:
    """Run a GET closure under the resilience policy: the breaker gates
    the call (open: ``StoreUnavailableError``, no network), transient
    failures (5xx, transport errors) retry with jittered backoff under a
    budget and the ambient deadline, and the outcome feeds the breaker.
    A 4xx returns at once: it is an answer, not an outage. ``point`` names
    the fault-injection point each attempt fires first."""
    try:
        breaker.allow()
    except BreakerOpenError as e:
        raise StoreUnavailableError(str(e), e.retry_after_s) from None

    def attempt() -> Tuple[int, bytes]:
        if point is not None:
            INJECTOR.fire(point)
        status, body = fn()
        if status in _RETRY_STATUSES:
            raise _TransientStatus(status, body)
        return status, body

    try:
        status, body = retry_call(attempt, retryable=(StoreError, _TransientStatus), name=name)
    except _TransientStatus as e:
        # retries spent on a 5xx: the caller raises with context
        breaker.record_failure()
        return e.status, e.body
    except (StoreError, OSError):
        breaker.record_failure()
        raise
    breaker.record_success()
    return status, body


def project_range(body: bytes, start: int, length: Optional[int]) -> bytes:
    """A whole object's body projected onto a byte range (a 200 answered
    to a ranged GET, a whole-key fallback). A negative ``start`` is a
    suffix, clamped to the body; ``length`` None reads to the end."""
    if start < 0:
        return body[start:] if -start <= len(body) else body
    end = None if length is None else start + length
    return body[start:end]


@dataclasses.dataclass(frozen=True)
class RangeReq:
    """One logical read: a whole key (``start=0, length=None``), a byte
    range ``[start, start+length)``, or a suffix (``start < 0``: the last
    ``-start`` bytes, how a shard index footer is read)."""

    key: str
    start: int = 0
    length: Optional[int] = None

    @property
    def whole(self) -> bool:
        return self.start == 0 and self.length is None


@dataclasses.dataclass
class _Planned:
    """One store request the planner issues, covering ``members``
    (indices into the deduplicated requests); a coalesced request spans
    [start, end) of one key."""

    key: str
    start: int
    end: Optional[int]       # None: whole key / open-ended
    members: List[int]
    suffix: bool = False
    whole: bool = False
    length_hint: Optional[int] = None  # suffix/open-ended length


def _coalesce(reqs: Sequence[RangeReq], order: List[int], gap: int) -> List[_Planned]:
    """Same-key bounded ranges ``order`` -> coalesced spans: sorted by
    start, merged while the gap stays within ``gap`` and the span within
    ``_MAX_COALESCED_BYTES``."""
    order = sorted(order, key=lambda i: reqs[i].start)
    plans: List[_Planned] = []
    for i in order:
        r = reqs[i]
        end = r.start + r.length
        cur = plans[-1] if plans else None
        if (cur is not None and r.start - cur.end <= gap
                and max(end, cur.end) - cur.start <= _MAX_COALESCED_BYTES):
            cur.end = max(cur.end, end)
            cur.members.append(i)
        else:
            plans.append(_Planned(r.key, r.start, end, [i]))
    return plans


_executor_lock = threading.Lock()
_fetch_executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
_decode_executor: Optional[concurrent.futures.ThreadPoolExecutor] = None


def _get_fetch_executor() -> concurrent.futures.ThreadPoolExecutor:
    global _fetch_executor
    with _executor_lock:
        if _fetch_executor is None:
            _fetch_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=FETCH_WORKERS, thread_name_prefix="io-fetch")
        return _fetch_executor


def _get_decode_executor() -> concurrent.futures.ThreadPoolExecutor:
    global _decode_executor
    with _executor_lock:
        if _decode_executor is None:
            _decode_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=DECODE_WORKERS, thread_name_prefix="io-decode")
        return _decode_executor


def map_parallel(fn: Callable, items: Sequence) -> List:
    """``fn`` over ``items`` on the bounded decode pool (zlib and zstd
    release the GIL; the pure-Python LZ4 does not); serial for a trivial
    batch. Exceptions propagate. The fetch and decode pools only run leaf
    work (a GET, a decode), never a read that waits on its own pool."""
    if len(items) <= 1:
        return [fn(it) for it in items]
    return list(_get_decode_executor().map(fn, items))


def _deadline_remaining() -> Optional[float]:
    deadline = current_deadline()
    if deadline is None:
        return None
    remaining = deadline.remaining()
    if remaining <= 0:
        raise DeadlineExceeded("io.fetch")
    return remaining


def _run_planned(store, plan: _Planned, stats: Optional[FetchStats] = None) -> Optional[bytes]:
    """Execute one planned request. A ``StoreError`` (never an open
    breaker) degrades to one whole-key GET sliced to the planned span, so
    a range-hostile origin costs time, not correctness; the extra request
    and its surplus bytes are counted."""
    if plan.whole:
        return store.get(plan.key)
    try:
        if plan.suffix:
            return store.get_range(plan.key, plan.start, plan.length_hint)
        return store.get_range(plan.key, plan.start, plan.end - plan.start)
    except StoreUnavailableError:
        raise  # open breaker: fail fast
    except StoreError:
        body = store.get(plan.key)
        sliced = None if body is None else project_range(
            body, plan.start, None if plan.end is None else plan.end - plan.start)
        surplus = 0 if body is None else len(body) - len(sliced)
        for s in (IO_STATS, stats) if stats is not None else (IO_STATS,):
            s.add(fallbacks=1, issued=1, bytes_discarded=max(0, surplus))
        return sliced


def fetch_many(store, requests: Sequence[RangeReq],
               stats: Optional[FetchStats] = None) -> List[Optional[bytes]]:
    """The planner: results align with ``requests`` (None where the key
    is absent). Dedupe, coalesce adjacent ranges per key, fan out on the
    shared executor (bounded by the per-host pool), slice coalesced
    bodies back apart."""
    n = len(requests)
    if n == 0:
        return []
    _deadline_remaining()  # a spent budget stops before any network
    t0 = time.monotonic()
    gap = COALESCE_GAP_BYTES
    ranged_ok = hasattr(store, "get_range")

    first_of: Dict[RangeReq, int] = {}
    alias: List[int] = [0] * n
    uniq: List[RangeReq] = []
    for i, r in enumerate(requests):
        j = first_of.get(r)
        if j is None:
            first_of[r] = j = len(uniq)
            uniq.append(r)
        alias[i] = j

    plans: List[_Planned] = []
    bounded_by_key: Dict[str, List[int]] = {}
    for i, r in enumerate(uniq):
        if r.whole or not ranged_ok:
            plans.append(_Planned(r.key, 0, None, [i], whole=True))
        elif r.start < 0 or r.length is None:
            plans.append(_Planned(r.key, r.start, None, [i], suffix=True,
                                  length_hint=r.length))
        else:
            bounded_by_key.setdefault(r.key, []).append(i)
    n_bounded = sum(len(v) for v in bounded_by_key.values())
    for order in bounded_by_key.values():
        plans.extend(_coalesce(uniq, order, gap))
    saved = n_bounded - sum(1 for p in plans if not p.whole and not p.suffix)

    bodies: List[Optional[bytes]] = [None] * len(plans)
    if len(plans) > 1:
        pool = _get_fetch_executor()
        futures = {pool.submit(_run_planned, store, p, stats): k for k, p in enumerate(plans)}
        err: Optional[BaseException] = None
        for fut, k in futures.items():
            try:
                bodies[k] = fut.result(timeout=_deadline_remaining())
            except concurrent.futures.TimeoutError:
                err = err or DeadlineExceeded("io.fetch")
            except (StoreError, DeadlineExceeded) as e:
                err = err or e
        if err is not None:
            raise err
    else:
        for k, p in enumerate(plans):
            bodies[k] = _run_planned(store, p, stats)

    out: List[Optional[bytes]] = [None] * len(uniq)
    nbytes = 0
    discarded = 0
    for p, body in zip(plans, bodies):
        if body is None:
            continue  # absent key: every member reads fill_value
        nbytes += len(body)
        if p.whole or p.suffix:
            for i in p.members:
                out[i] = _slice_for(uniq[i], body, whole=p.whole)
        else:
            used = 0
            for i in p.members:
                r = uniq[i]
                lo = r.start - p.start
                out[i] = body[lo:lo + r.length]
                used += min(r.length, max(0, len(body) - lo))
            discarded += max(0, len(body) - used)

    ranged = sum(1 for p in plans if not p.whole)
    for s in (IO_STATS, stats) if stats is not None else (IO_STATS,):
        s.add(planned=len(uniq), issued=len(plans), ranged=ranged,
              coalesced_saved=max(0, saved), bytes_fetched=nbytes,
              bytes_discarded=discarded, batches=1)
    dt = time.monotonic() - t0
    IO_FETCH_SECONDS.observe(dt)
    defer_exemplar(IO_FETCH_SECONDS, dt)
    return [out[alias[i]] for i in range(n)]


def _slice_for(r: RangeReq, body: bytes, whole: bool) -> bytes:
    """A whole-key (fallback) or suffix body projected onto one request."""
    if not whole or r.whole:
        return body
    return project_range(body, r.start, r.length)
