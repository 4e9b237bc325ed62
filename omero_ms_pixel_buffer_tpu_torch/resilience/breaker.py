"""Circuit breakers: per-dependency failure isolation (the part of
``omero_ms_pixel_buffer_tpu/resilience/breaker.py`` the stores use).

A breaker turns "slow failure, every time" into "fast failure until the
dependency heals". Three states:

- ``closed``: calls flow and outcomes are recorded. It opens on
  ``FAILURE_THRESHOLD`` consecutive failures, or on a failure rate of at
  least ``FAILURE_RATE_THRESHOLD`` over the last ``WINDOW`` calls (once
  ``MIN_CALLS`` outcomes exist).
- ``open``: calls are rejected at once with ``BreakerOpenError`` until
  ``OPEN_DURATION_S`` has passed.
- ``half_open``: up to ``HALF_OPEN_PROBES`` trial calls pass; a success
  closes the breaker (history cleared), a failure opens it again.

The thresholds are the JAX package's defaults, as module constants: its
per-dependency overrides and slow-call rule wait for the YAML
``resilience:`` block and a caller that times its calls. Thread-safe; the
clock is injectable. The JAX package exports states and transitions to
Prometheus and takes fleet-gossip hints (``suspect``, ``heal``) from its
cluster plane; the port has neither yet, so each breaker keeps its counts
in ``snapshot()`` (``/healthz`` ``breakers``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict

CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"

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
    def __init__(self, name: str, clock=time.monotonic):
        self.name = name
        self.clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._outcomes: deque = deque(maxlen=WINDOW)  # True for a failure
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        self._probe_admitted_at = 0.0
        self._stats = {"rejected": 0, "opened": 0, "transitions": 0}

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

    def allow(self) -> None:
        """Gate a call: nothing when closed, a bounded number of probes
        when half-open, ``BreakerOpenError`` when open."""
        with self._lock:
            if self._state == OPEN:
                elapsed = self.clock() - self._opened_at
                if elapsed < OPEN_DURATION_S:
                    self._stats["rejected"] += 1
                    raise BreakerOpenError(self.name, OPEN_DURATION_S - elapsed)
                self._transition(HALF_OPEN)
            if self._state == HALF_OPEN:
                if self._probes_in_flight >= HALF_OPEN_PROBES:
                    # a probe that never reported within a whole open
                    # period was lost (its caller gave up): admit another
                    if self.clock() - self._probe_admitted_at >= OPEN_DURATION_S:
                        self._probes_in_flight = 0
                    else:
                        self._stats["rejected"] += 1
                        raise BreakerOpenError(self.name, 0.0)
                self._probes_in_flight += 1
                self._probe_admitted_at = self.clock()

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._transition(CLOSED)
                return
            self._consecutive_failures = 0
            self._outcomes.append(False)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._transition(OPEN)
                return
            if self._state == OPEN:
                return
            self._consecutive_failures += 1
            self._outcomes.append(True)
            if self._consecutive_failures >= FAILURE_THRESHOLD:
                self._transition(OPEN)
                return
            if len(self._outcomes) >= MIN_CALLS:
                if sum(self._outcomes) / len(self._outcomes) >= FAILURE_RATE_THRESHOLD:
                    self._transition(OPEN)

    def _visible_state(self) -> str:
        # callers hold self._lock; an open period that has passed reads
        # half-open (the next call would be admitted as a probe)
        if self._state == OPEN and self.clock() - self._opened_at >= OPEN_DURATION_S:
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
                "consecutive_failures": self._consecutive_failures,
                "window_failures": sum(self._outcomes),
                "window_size": len(self._outcomes),
                "rejected_total": self._stats["rejected"],
                "opened_total": self._stats["opened"],
                "transitions_total": self._stats["transitions"],
            }

    def reset(self) -> None:
        with self._lock:
            self._transition(CLOSED)


class BreakerBoard:
    """Process-wide breakers, one per dependency name, held strongly: the
    failure history belongs to the dependency, not to one client, so a
    store re-made per request still trips its breaker. (The JAX board's
    ``configure`` of defaults and of a disabled layer waits for the YAML
    ``resilience:`` block.)"""

    _MAX_BREAKERS = 1024

    def __init__(self):
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def create(self, name: str) -> CircuitBreaker:
        """The breaker of dependency ``name``, made on first use."""
        with self._lock:
            breaker = self._breakers.get(name)
            if breaker is None:
                if len(self._breakers) >= self._MAX_BREAKERS:
                    self._breakers.clear()  # coarse but bounded
                breaker = self._breakers[name] = CircuitBreaker(name)
        return breaker

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._breakers.items())
        return {name: b.snapshot() for name, b in items}

    def reset(self) -> None:
        """Forget every breaker (tests)."""
        with self._lock:
            for b in self._breakers.values():
                b.reset()
            self._breakers = {}


BOARD = BreakerBoard()


def for_dependency(name: str) -> CircuitBreaker:
    """The breaker of one dependency on the process-wide board."""
    return BOARD.create(name)
