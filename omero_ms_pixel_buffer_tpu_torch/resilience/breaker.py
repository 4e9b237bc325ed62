"""Circuit breakers: per-dependency failure isolation (counterpart of
``omero_ms_pixel_buffer_tpu/resilience/breaker.py``).

A breaker turns "slow failure, every time" into "fast failure until the
dependency heals". Three states:

- ``closed``: calls flow and outcomes are recorded. It opens on
  ``failure_threshold`` consecutive failures, on a failure rate of at
  least ``failure_rate_threshold`` over the last ``window`` calls (once
  ``min_calls`` outcomes exist), or, with ``slow_call_duration_s`` > 0,
  on a share of slow successes of at least ``slow_call_rate_threshold``.
- ``open``: calls are rejected at once with ``BreakerOpenError`` until
  ``open_duration_s`` has passed.
- ``half_open``: up to ``half_open_probes`` trial calls pass; a success
  closes the breaker (history cleared), a slow success or a failure
  opens it again.

The defaults are the JAX package's (the module constants below); the
YAML ``resilience.breaker`` block sets them process-wide through
``BOARD.configure`` (``resilience.configure``), and ``enabled: false``
hands out ``NULL_BREAKER``. Thread-safe; the clock is injectable. States,
transitions, rejections and slow calls go to ``/metrics`` under the JAX
names; each breaker also keeps its counts in ``snapshot()`` (``/healthz``
``breakers``). The fleet brains (``cluster/brains.py``) mark a breaker
``suspect`` when a strict majority of peers hold its dependency open:
the next local failure then trips it at once, and a local success clears
the hint.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

from ..utils.metrics import REGISTRY

BREAKER_STATE = REGISTRY.gauge(
    "resilience_breaker_state",
    "Circuit-breaker state per dependency (0=closed 1=half_open 2=open)",
)
BREAKER_TRANSITIONS = REGISTRY.counter(
    "resilience_breaker_transitions_total",
    "Circuit-breaker state transitions by dependency and new state",
)
BREAKER_REJECTED = REGISTRY.counter(
    "resilience_breaker_rejected_total",
    "Calls rejected by an open circuit breaker",
)
BREAKER_SLOW = REGISTRY.counter(
    "resilience_breaker_slow_calls_total",
    "Successful calls that exceeded the slow-call duration threshold",
)

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

FAILURE_THRESHOLD = 5         # consecutive failures that open
FAILURE_RATE_THRESHOLD = 0.5  # failure share of the window that opens
WINDOW = 20                   # outcomes in the sliding window
MIN_CALLS = 10                # outcomes before the rate rule applies
OPEN_DURATION_S = 30.0        # rejection period before a probe
HALF_OPEN_PROBES = 1          # trial calls admitted while half-open


class BreakerOpenError(RuntimeError):
    """Rejected without calling the dependency: its breaker is open.
    ``retry_after_s`` is the time until the next half-open probe."""

    def __init__(self, dependency: str, retry_after_s: float):
        super().__init__(f"circuit breaker open for {dependency} "
                         f"(retry in {retry_after_s:.1f}s)")
        self.dependency = dependency
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    def __init__(
        self,
        name: str,
        failure_threshold: int = FAILURE_THRESHOLD,
        failure_rate_threshold: float = FAILURE_RATE_THRESHOLD,
        window: int = WINDOW,
        min_calls: int = MIN_CALLS,
        open_duration_s: float = OPEN_DURATION_S,
        half_open_probes: int = HALF_OPEN_PROBES,
        slow_call_duration_s: float = 0.0,
        slow_call_rate_threshold: float = 1.0,
        clock=time.monotonic,
    ):
        self.name = name
        self.failure_threshold = failure_threshold
        self.failure_rate_threshold = failure_rate_threshold
        self.window = window
        self.min_calls = min_calls
        self.open_duration_s = open_duration_s
        self.half_open_probes = half_open_probes
        # 0 disables the slow-call rule
        self.slow_call_duration_s = slow_call_duration_s
        self.slow_call_rate_threshold = slow_call_rate_threshold
        self.clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._outcomes: deque = deque(maxlen=window)  # (failure, slow) per call
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self._probe_admitted_at = 0.0
        # fleet hint (cluster/brains): peers hold this dependency open.
        # It never opens the breaker by itself; the next local failure
        # trips at once, and a local success clears it
        self._suspect = False
        self._stats = {"rejected": 0, "opened": 0, "transitions": 0, "slow": 0}
        BREAKER_STATE.set(0, dependency=name)

    def _transition(self, state: str) -> None:
        # callers hold self._lock
        if state == self._state:
            return
        self._state = state
        self._stats["transitions"] += 1
        if state == OPEN:
            self._opened_at = self.clock()
            self._stats["opened"] += 1
        if state in (OPEN, HALF_OPEN):
            self._probes_in_flight = 0
        if state == CLOSED:
            self._outcomes.clear()
            self._consecutive_failures = 0
        BREAKER_STATE.set(_STATE_CODE[state], dependency=self.name)
        BREAKER_TRANSITIONS.inc(dependency=self.name, state=state)

    def allow(self) -> None:
        """Gate a call: nothing when closed, a bounded number of probes
        when half-open, ``BreakerOpenError`` when open."""
        with self._lock:
            if self._state == OPEN:
                elapsed = self.clock() - self._opened_at
                if elapsed < self.open_duration_s:
                    self._stats["rejected"] += 1
                    BREAKER_REJECTED.inc(dependency=self.name)
                    raise BreakerOpenError(self.name, self.open_duration_s - elapsed)
                self._transition(HALF_OPEN)
            if self._state == HALF_OPEN:
                if self._probes_in_flight >= self.half_open_probes:
                    # a probe that never reported within a whole open
                    # period was lost (its caller gave up): admit another
                    if self.clock() - self._probe_admitted_at >= self.open_duration_s:
                        self._probes_in_flight = 0
                    else:
                        self._stats["rejected"] += 1
                        BREAKER_REJECTED.inc(dependency=self.name)
                        raise BreakerOpenError(self.name, 0.0)
                self._probes_in_flight += 1
                self._probe_admitted_at = self.clock()

    def _is_slow(self, duration_s: Optional[float]) -> bool:
        return (self.slow_call_duration_s > 0 and duration_s is not None
                and duration_s >= self.slow_call_duration_s)

    def record_success(self, duration_s: Optional[float] = None) -> None:
        """Record a correct answer; ``duration_s``, where the caller timed
        the call, feeds the slow-call rule."""
        slow = self._is_slow(duration_s)
        with self._lock:
            if slow:
                self._stats["slow"] += 1
                BREAKER_SLOW.inc(dependency=self.name)
            if self._state == HALF_OPEN:
                # a probe that answers at outage latency has not healed
                self._transition(OPEN if slow else CLOSED)
                return
            self._consecutive_failures = 0
            self._suspect = False  # a live answer disproves the rumour
            self._outcomes.append((False, slow))
            if slow and len(self._outcomes) >= self.min_calls:
                rate = sum(1 for _f, s in self._outcomes if s) / len(self._outcomes)
                if rate >= self.slow_call_rate_threshold:
                    self._transition(OPEN)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._transition(OPEN)
                return
            if self._state == OPEN:
                return
            self._consecutive_failures += 1
            self._outcomes.append((True, False))
            if self._suspect:
                # the fleet already spent the failure budget
                self._suspect = False
                self._transition(OPEN)
                return
            if self._consecutive_failures >= self.failure_threshold:
                self._transition(OPEN)
                return
            if len(self._outcomes) >= self.min_calls:
                rate = sum(1 for f, _s in self._outcomes if f) / len(self._outcomes)
                if rate >= self.failure_rate_threshold:
                    self._transition(OPEN)

    def heal(self) -> None:
        """Close at once: an active probe (not a gated call) found the
        dependency answering, so the half-open trial has nothing left to
        learn (the mesh manager's device probes)."""
        with self._lock:
            self._transition(CLOSED)

    def suspect(self) -> None:
        """Fleet hint: a majority of peers hold this dependency open.
        Sensitise, never open: the next local failure trips at once."""
        with self._lock:
            if self._state == CLOSED:
                self._suspect = True

    def clear_suspect(self) -> None:
        with self._lock:
            self._suspect = False

    def _visible_state(self) -> str:
        # callers hold self._lock; an open period that has passed reads
        # half-open (the next call would be admitted as a probe)
        if self._state == OPEN and self.clock() - self._opened_at >= self.open_duration_s:
            return HALF_OPEN
        return self._state

    @property
    def state(self) -> str:
        with self._lock:
            return self._visible_state()

    def snapshot(self) -> dict:
        """The ``/healthz`` view of one breaker."""
        with self._lock:
            return {
                "state": self._visible_state(),
                "suspect": self._suspect,
                "consecutive_failures": self._consecutive_failures,
                "window_failures": sum(1 for f, _s in self._outcomes if f),
                "window_slow": sum(1 for _f, s in self._outcomes if s),
                "window_size": len(self._outcomes),
                "rejected_total": self._stats["rejected"],
                "opened_total": self._stats["opened"],
                "transitions_total": self._stats["transitions"],
                "slow_total": self._stats["slow"],
            }

    def reset(self) -> None:
        with self._lock:
            self._transition(CLOSED)


class BreakerBoard:
    """Process-wide breakers, one per dependency name, held strongly: the
    failure history belongs to the dependency, not to one client, so a
    store re-made per request still trips its breaker. ``configure`` sets
    the thresholds of breakers made after it; ``enabled=False`` hands
    out ``NULL_BREAKER``."""

    _MAX_BREAKERS = 1024

    def __init__(self):
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()
        self.enabled = True
        self.defaults: dict = {}

    def configure(self, enabled: bool = True, **defaults) -> None:
        with self._lock:
            self.enabled = enabled
            self.defaults = dict(defaults)

    def create(self, name: str, **overrides):
        """The breaker of dependency ``name``, made on first use (a fresh
        one when ``overrides`` are given)."""
        with self._lock:
            if not self.enabled:
                return NULL_BREAKER
            breaker = self._breakers.get(name)
            if breaker is None or overrides:
                if name not in self._breakers and len(self._breakers) >= self._MAX_BREAKERS:
                    self._breakers.clear()  # coarse but bounded
                breaker = self._breakers[name] = CircuitBreaker(
                    name, **{**self.defaults, **overrides})
        return breaker

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._breakers.items())
        return {name: b.snapshot() for name, b in items}

    def reset(self) -> None:
        """Forget every breaker and the configured defaults (tests)."""
        with self._lock:
            for b in self._breakers.values():
                b.reset()
            self._breakers = {}
            self.enabled = True
            self.defaults = {}


class NullBreaker:
    """The stand-in of a disabled resilience layer: the same surface, no
    state."""

    name = "null"
    state = CLOSED

    def allow(self) -> None:
        pass

    def record_success(self, duration_s: Optional[float] = None) -> None:
        pass

    def record_failure(self) -> None:
        pass

    def heal(self) -> None:
        pass

    def suspect(self) -> None:
        pass

    def clear_suspect(self) -> None:
        pass

    def snapshot(self) -> dict:
        return {"state": CLOSED}

    def reset(self) -> None:
        pass


NULL_BREAKER = NullBreaker()
BOARD = BreakerBoard()


def for_dependency(name: str, **overrides):
    """The breaker of one dependency on the process-wide board."""
    return BOARD.create(name, **overrides)
