"""SLO-aware request scheduling (copy of ``omero_ms_pixel_buffer_tpu/
resilience/scheduler.py``, with the fleet-brain hook
``note_fleet_pressure``).

- **Priority classes**: ``INTERACTIVE`` > ``PREFETCH`` > ``BULK``. An
  ``x-ompb-priority`` header wins, the prefetch purpose headers
  (``Sec-Purpose``/``Purpose: prefetch``, ``X-OMPB-Prefetch``) mark the
  middle class, and the ``SweepDetector`` demotes a session whose accesses
  are a long constant-stride scan to ``BULK``.
- **The deadline-aware queue** (``SloScheduler``): the
  ``AdmissionController`` bounds the executing slots; past it requests
  wait in per-class earliest-deadline-first heaps, granted EDF within a
  class and weighted round robin (8, 2, 1) between classes. Only a full
  wait queue sheds (503 with ``Retry-After``), and the victim is the
  lowest-class, latest-deadline entry among the waiters and the arrival.
  A waiter whose deadline passes before its grant answers 504.
- **The degradation signal**: an EWMA of full-resolution service time;
  a grant that waited and whose remaining budget is under
  ``degrade_factor`` times the estimate comes back flagged, and the front
  serves the next-lower pyramid level upscaled (``X-OMPB-Degraded``).
- ``DeadlineQueue``: the batcher's intake, popped in (deadline, class)
  order.

Per-class sheds, degraded grants and queue expiries go to ``/metrics``
under the JAX names (``slo_*``), with the queue wait's histogram
(``slo_queue_wait_seconds``, its exemplar deferred to the request's flight
record); ``SloScheduler.snapshot`` holds the same counts (``/healthz``
``slo``).
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import List, Optional, Tuple

from ..errors import GatewayTimeoutError, ServiceUnavailableError
from ..obs.recorder import defer_exemplar
from ..utils.metrics import REGISTRY
from .admission import AdmissionController
from .deadline import Deadline

PRIORITY_INTERACTIVE = 0
PRIORITY_PREFETCH = 1
PRIORITY_BULK = 2

PRIORITY_NAMES = {
    PRIORITY_INTERACTIVE: "interactive",
    PRIORITY_PREFETCH: "prefetch",
    PRIORITY_BULK: "bulk",
}
PRIORITY_BY_NAME = {v: k for k, v in PRIORITY_NAMES.items()}

SLO_SHED = REGISTRY.counter(
    "slo_shed_total",
    "Requests shed (503) by the SLO scheduler, by class",
)
SLO_DEGRADED = REGISTRY.counter(
    "slo_degraded_total",
    "Permits granted with the hybrid-resolution degradation flag, "
    "by class",
)
SLO_EXPIRED = REGISTRY.counter(
    "slo_queue_expired_total",
    "Requests whose deadline expired while waiting in the SLO queue, "
    "by class",
)
SLO_QUEUE_WAIT = REGISTRY.histogram(
    "slo_queue_wait_seconds",
    "Time spent waiting in the SLO queue before a grant",
)

# the JAX package's slo: defaults
QUEUE_SIZE = 512
CLASS_WEIGHTS = (8, 2, 1)
DEGRADE_FACTOR = 1.5
EWMA_ALPHA = 0.2  # weight of the newest service time in the estimate
SWEEP_WINDOW = 16
SWEEP_TTL_S = 30.0
PRIORITY_HEADER = "x-ompb-priority"


class SweepDetector:
    """Marks sessions whose access pattern is a machine sweep: per
    (session, image, plane, level) stream it keeps the last position and
    stride and counts how long the stride stays constant; past
    ``threshold`` constant steps the session is ``BULK`` for ``ttl_s``
    (refreshed while the sweep goes on). Thread-safe."""

    def __init__(self, threshold: int = SWEEP_WINDOW, ttl_s: float = SWEEP_TTL_S,
                 max_streams: int = 1024, clock=time.monotonic):
        self.threshold = max(2, int(threshold))
        self.ttl_s = ttl_s
        self._clock = clock
        self._max_streams = max_streams
        self._streams: "OrderedDict[tuple, list]" = OrderedDict()  # key -> [x, y, dx, dy, run]
        self._bulk: "OrderedDict[object, float]" = OrderedDict()  # session -> expiry
        self._lock = threading.Lock()
        self.detected_total = 0

    def observe(self, session, image_id: int, z: int, c: int, t: int, resolution,
                x: int, y: int, w: int, h: int) -> None:
        """Feed one access; full-plane requests (w or h 0) carry no grid."""
        if session is None or w <= 0 or h <= 0:
            return
        key = (session, image_id, z, c, t, resolution)
        with self._lock:
            stream = self._streams.get(key)
            if stream is None:
                self._streams[key] = [x, y, 0, 0, 0]
                while len(self._streams) > self._max_streams:
                    self._streams.popitem(last=False)
                return
            self._streams.move_to_end(key)
            dx, dy = x - stream[0], y - stream[1]
            if (dx, dy) == (0, 0):
                return  # a refresh, not a step
            if (dx, dy) == (stream[2], stream[3]):
                stream[4] += 1
            else:
                stream[4] = 1
            stream[0], stream[1] = x, y
            stream[2], stream[3] = dx, dy
            if stream[4] >= self.threshold:
                if session not in self._bulk:
                    self.detected_total += 1
                self._bulk[session] = self._clock() + self.ttl_s
                self._bulk.move_to_end(session)
                while len(self._bulk) > self._max_streams:
                    self._bulk.popitem(last=False)

    def is_sweep(self, session) -> bool:
        if session is None:
            return False
        with self._lock:
            expiry = self._bulk.get(session)
            if expiry is None:
                return False
            if expiry <= self._clock():
                del self._bulk[session]
                return False
            return True

    def snapshot(self) -> dict:
        with self._lock:
            now = self._clock()
            return {
                "streams": len(self._streams),
                "bulk_sessions": sum(1 for e in self._bulk.values() if e > now),
                "detected_total": self.detected_total,
                "threshold": self.threshold,
            }


def header_priority(headers, override_header: str = PRIORITY_HEADER) -> Optional[int]:
    """The class the request's headers alone decide, or None (a labelled
    request does not train the sweep detector). Header names match in any
    case (the port's front lower-cases them, as aiohttp's lookups ignore
    case)."""
    headers = {k.lower(): v for k, v in headers.items()}
    if override_header:
        explicit = headers.get(override_header.lower())
        if explicit:
            prio = PRIORITY_BY_NAME.get(explicit.strip().lower())
            if prio is not None:
                return prio
    purpose = headers.get("sec-purpose") or headers.get("purpose") or ""
    if "prefetch" in purpose.lower() or headers.get("x-ompb-prefetch"):
        return PRIORITY_PREFETCH
    return None


def classify(headers, session, detector: Optional[SweepDetector] = None,
             override_header: str = PRIORITY_HEADER) -> int:
    """Header override > prefetch purpose headers > sweep detection >
    interactive."""
    prio = header_priority(headers, override_header)
    if prio is not None:
        return prio
    if detector is not None and detector.is_sweep(session):
        return PRIORITY_BULK
    return PRIORITY_INTERACTIVE


class Permit:
    """One granted execution slot; ``degraded`` asks for the
    hybrid-resolution fallback, ``queued_s`` is the wait before it."""

    __slots__ = ("priority", "degraded", "queued_s", "_t_start")

    def __init__(self, priority: int, degraded: bool = False, queued_s: float = 0.0):
        self.priority = priority
        self.degraded = degraded
        self.queued_s = queued_s
        self._t_start = time.monotonic()


class _Waiter:
    __slots__ = ("priority", "deadline", "fut", "seq", "cancelled", "popped", "enqueued_at",
                 "degradable")

    def __init__(self, priority, deadline, fut, seq, degradable=True):
        self.priority = priority
        self.deadline = deadline
        self.fut = fut
        self.seq = seq
        self.cancelled = False
        self.popped = False
        self.enqueued_at = time.monotonic()
        self.degradable = degradable

    @property
    def expires_at(self) -> float:
        return float("inf") if self.deadline is None else self.deadline.expires_at


class SloScheduler:
    """The deadline-aware admission queue. ``acquire``/``release`` run on
    the serving loop; ``snapshot`` may run anywhere."""

    def __init__(self, admission: AdmissionController, queue_size: int = QUEUE_SIZE,
                 class_weights: Tuple[int, int, int] = CLASS_WEIGHTS,
                 degrade: bool = True, degrade_factor: float = DEGRADE_FACTOR,
                 clock=time.monotonic):
        self.admission = admission
        self.degrade_enabled = degrade
        self.queue_size = max(0, int(queue_size))
        self.class_weights = tuple(max(1, int(w)) for w in class_weights)
        self.degrade_factor = degrade_factor
        self._clock = clock
        self._heaps: List[list] = [[], [], []]  # per class, EDF min-heaps
        self._waiting = [0, 0, 0]  # live waiters per class
        self._credits = list(self.class_weights)
        self._seq = itertools.count()
        self._service_ewma = 0.0
        self.classified = [0, 0, 0]
        self.sheds = [0, 0, 0]
        self.degraded = [0, 0, 0]
        self.expired_in_queue = [0, 0, 0]
        self.granted = [0, 0, 0]
        # fleet-brain hint (cluster/brains.py): the mean of the peers'
        # queue pressure. With the fleet saturated (``fleet_engaged``)
        # this replica is about to inherit spillover, so even an
        # uncontended grant takes the degrade check. Advisory only: it
        # never sheds or queues, and decays when the brains report calm
        self.fleet_pressure = 0.0
        self.fleet_engaged = False
        # graceful drain (cluster/lifecycle.py): a draining replica
        # finishes real work at full resolution; it stops minting
        # degraded permits (their entries would be handed off to nobody)
        # but never sheds or queues differently
        self.draining = False

    @property
    def _waiting_total(self) -> int:
        return sum(self._waiting)

    def _degrade_flag(self, deadline: Optional[Deadline],
                      contended: bool = True) -> bool:
        """A grant that waited serves the fallback when its remaining
        budget is under ``degrade_factor`` x the service-time estimate."""
        if deadline is None or not self.degrade_enabled or self.draining:
            return False
        if not contended and not self.fleet_engaged:
            return False
        if self._service_ewma <= 0.0:
            return False
        return deadline.remaining() < self._service_ewma * self.degrade_factor

    def _shed_error(self) -> ServiceUnavailableError:
        return ServiceUnavailableError("Service overloaded",
                                       retry_after_s=self.admission.retry_after_s)

    def _count_shed(self, priority: int) -> None:
        self.sheds[priority] += 1
        SLO_SHED.inc(priority=PRIORITY_NAMES[priority])
        self.admission.count_shed()

    def _worst_waiter(self) -> Optional[_Waiter]:
        """The shed victim: latest deadline in the lowest class waiting."""
        for priority in (PRIORITY_BULK, PRIORITY_PREFETCH, PRIORITY_INTERACTIVE):
            live = [e for _, _, e in self._heaps[priority] if not e.cancelled]
            if live:
                return max(live, key=lambda e: (e.expires_at, e.seq))
        return None

    def would_overflow_shed(self, priority: int) -> bool:
        """Would an arrival of ``priority`` with a fresh budget shed now?
        The door gate's read-only preview."""
        priority = min(max(int(priority), 0), PRIORITY_BULK)
        if self._waiting_total == 0 and (
                self.admission.inflight < self.admission.max_inflight):
            return False  # would grant at once
        if self.queue_size == 0:
            return True
        if self._waiting_total < self.queue_size:
            return False  # room to wait
        # a fresh arrival carries the latest deadline in sight: it sheds
        # unless a strictly lower class is waiting to be evicted
        for lower in range(PRIORITY_BULK, priority, -1):
            if self._waiting[lower] > 0:
                return False
        return True

    def note_fleet_pressure(self, pressure: float, engaged: bool = False) -> None:
        """The fleet brains' hook (any thread: two scalar writes)."""
        self.fleet_pressure = max(0.0, float(pressure))
        self.fleet_engaged = bool(engaged)

    def note_draining(self, draining: bool) -> None:
        """The drain protocol's hook: one scalar write."""
        self.draining = bool(draining)

    def shed_at_door(self, priority: int) -> None:
        """Count a door shed in the counters ``acquire``'s sheds use."""
        priority = min(max(int(priority), 0), PRIORITY_BULK)
        self.classified[priority] += 1
        self._count_shed(priority)

    async def acquire(self, priority: int, deadline: Optional[Deadline],
                      degradable: bool = True) -> Permit:
        """One execution slot, or ``ServiceUnavailableError`` (shed) or
        ``GatewayTimeoutError`` (expired while waiting). A grant of
        ``degradable=False`` is never flagged."""
        priority = min(max(int(priority), 0), PRIORITY_BULK)
        self.classified[priority] += 1
        if self._waiting_total == 0 and self.admission.try_slot():
            self.granted[priority] += 1
            return Permit(priority, degraded=False)
        if self.queue_size == 0:
            self._count_shed(priority)
            raise self._shed_error()
        if self._waiting_total >= self.queue_size:
            victim = self._worst_waiter()
            incoming_key = (priority,
                            float("inf") if deadline is None else deadline.expires_at)
            if victim is None or incoming_key >= (victim.priority, victim.expires_at):
                self._count_shed(priority)
                raise self._shed_error()
            # evict the queued victim: its waiter gets the 503
            victim.cancelled = True
            self._waiting[victim.priority] -= 1
            self._count_shed(victim.priority)
            if not victim.fut.done():
                victim.fut.set_exception(self._shed_error())
        entry = _Waiter(priority, deadline, asyncio.get_running_loop().create_future(),
                        next(self._seq), degradable=degradable)
        heapq.heappush(self._heaps[priority], (entry.expires_at, entry.seq, entry))
        self._waiting[priority] += 1
        try:
            permit = await entry.fut
        except asyncio.CancelledError:
            # the caller gave up: lazy delete; a grant that raced the
            # cancellation returns its slot untrained
            if not entry.cancelled and not entry.popped:
                entry.cancelled = True
                self._waiting[priority] -= 1
            if entry.fut.done() and not entry.fut.cancelled():
                if entry.fut.exception() is None:
                    self.release(entry.fut.result(), train=False)  # ompb-lint: disable=loop-block -- the future is done (checked above): result() returns at once, never blocks
            raise
        SLO_QUEUE_WAIT.observe(permit.queued_s)
        defer_exemplar(SLO_QUEUE_WAIT, permit.queued_s)
        return permit

    def release(self, permit: Permit, train: bool = True) -> None:
        """Hand the slot back, train the full-resolution service-time
        estimate (not on failures, not on degraded serves) and grant the
        next waiters."""
        duration = time.monotonic() - permit._t_start
        if train and not permit.degraded:
            self._service_ewma = (
                duration if self._service_ewma == 0.0
                else EWMA_ALPHA * duration + (1 - EWMA_ALPHA) * self._service_ewma
            )
        self.admission.release()
        self._dispatch_next()

    def _next_entry(self) -> Optional[_Waiter]:
        """Weighted round robin between classes, EDF within one; credits
        refill from the weights when every waiting class is out."""
        for _ in range(2):  # the second pass runs after a refill
            for priority in (PRIORITY_INTERACTIVE, PRIORITY_PREFETCH, PRIORITY_BULK):
                heap = self._heaps[priority]
                while heap and heap[0][2].cancelled:
                    heapq.heappop(heap)
                if heap and self._credits[priority] > 0:
                    self._credits[priority] -= 1
                    _, _, entry = heapq.heappop(heap)
                    entry.popped = True
                    self._waiting[priority] -= 1
                    return entry
            if not any(any(not e.cancelled for _, _, e in self._heaps[p]) for p in range(3)):
                return None
            self._credits = list(self.class_weights)
        return None

    def _dispatch_next(self) -> None:
        while self._waiting_total > 0 and self.admission.try_slot():
            entry = self._next_entry()
            if entry is None:
                self.admission.release()
                return
            if entry.fut.done():
                self.admission.release()
                continue
            if entry.deadline is not None and entry.deadline.expired:
                # a grant would burn the slot on a certain 504
                self.expired_in_queue[entry.priority] += 1
                SLO_EXPIRED.inc(priority=PRIORITY_NAMES[entry.priority])
                self.admission.release()
                entry.fut.set_exception(GatewayTimeoutError(
                    "Request deadline expired in the scheduler queue"))
                continue
            self.granted[entry.priority] += 1
            flag = entry.degradable and self._degrade_flag(entry.deadline)
            if flag:
                self.degraded[entry.priority] += 1
                SLO_DEGRADED.inc(priority=PRIORITY_NAMES[entry.priority])
            entry.fut.set_result(Permit(entry.priority, degraded=flag,
                                        queued_s=time.monotonic() - entry.enqueued_at))

    def snapshot(self) -> dict:
        names = [PRIORITY_NAMES[p] for p in range(3)]
        return {
            "enabled": True,
            "queue_size": self.queue_size,
            "queued": dict(zip(names, self._waiting)),
            "classified": dict(zip(names, self.classified)),
            "granted": dict(zip(names, self.granted)),
            "shed": dict(zip(names, self.sheds)),
            "degraded": dict(zip(names, self.degraded)),
            "expired_in_queue": dict(zip(names, self.expired_in_queue)),
            "service_ewma_ms": round(self._service_ewma * 1000.0, 3),
            "class_weights": list(self.class_weights),
            "fleet_pressure": round(self.fleet_pressure, 4),
            "fleet_engaged": self.fleet_engaged,
            "draining": self.draining,
        }


class DeadlineQueue:
    """An asyncio queue popped in (deadline, class) order: the batcher's
    intake, so batches form deadline-coherently. Deadline is the primary
    key (every entry already holds a granted slot, and one server-wide
    budget makes deadlines arrival-ordered), class breaks ties. The slice
    of ``asyncio.Queue`` the batcher uses; items are ``(ctx, fut)``."""

    def __init__(self, maxsize: int = 0):
        self.maxsize = maxsize
        self._heap: list = []
        self._seq = itertools.count()
        self._getters: "deque[asyncio.Future]" = deque()

    @staticmethod
    def _key(ctx) -> Tuple[float, int]:
        deadline = getattr(ctx, "deadline", None)
        return (float("inf") if deadline is None else deadline.expires_at,
                int(getattr(ctx, "priority", 0) or 0))

    def put_nowait(self, item) -> None:
        if 0 < self.maxsize <= len(self._heap):
            raise asyncio.QueueFull
        heapq.heappush(self._heap, (*self._key(item[0]), next(self._seq), item))
        while self._getters:
            getter = self._getters.popleft()
            if not getter.done():
                getter.set_result(None)
                break

    def get_nowait(self):
        if not self._heap:
            raise asyncio.QueueEmpty
        return heapq.heappop(self._heap)[-1]

    async def get(self):
        while not self._heap:
            getter = asyncio.get_running_loop().create_future()
            self._getters.append(getter)
            try:
                await getter
            except asyncio.CancelledError:
                # pass on a wakeup this getter may have consumed
                if getter.done() and not getter.cancelled():
                    while self._getters:
                        nxt = self._getters.popleft()
                        if not nxt.done():
                            nxt.set_result(None)
                            break
                raise
        return heapq.heappop(self._heap)[-1]

    def empty(self) -> bool:
        return not self._heap

    def qsize(self) -> int:
        return len(self._heap)
