"""Deterministic fault injection (copy of ``omero_ms_pixel_buffer_tpu/
resilience/faultinject.py``). A point that fires is noted on the ambient
flight record (``obs/recorder.py`` ``note_fault``).

Named injection points sit at the port's counterparts of the JAX sites:
``store.http``, ``store.s3`` and ``io.range-get`` (a store GET attempt),
``render.engine`` (a render encode group), ``render.supertile`` (a fused
super-tile), ``analysis.engine`` (a device histogram group) and
``device.encode-group`` (the encode queue's submit). Each consults the
process-wide ``INJECTOR`` with one dict lookup, so an empty injector
costs nothing. Tests install *schedules*, pure functions of the call
index: ``None`` passes, ``Fail(exc)`` raises before the work, and
``Latency(seconds)`` delays, then passes. Executor-thread sites call
``fire``; coroutines ``fire_async``. Nothing on the serving path installs
a schedule.
"""

from __future__ import annotations

import asyncio
import random
import threading
import time
from typing import Callable, Dict, Optional

from ..obs.recorder import note_fault


class Fail:
    """Raise ``exc`` (a factory or an instance) instead of the work."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc

    def raise_(self) -> None:
        raise self.exc() if callable(self.exc) else self.exc


class Latency:
    __slots__ = ("seconds",)

    def __init__(self, seconds: float):
        self.seconds = seconds


Outcome = Optional[object]  # None | Fail | Latency
Schedule = Callable[[int], Outcome]


def always(exc) -> Schedule:
    return lambda n: Fail(exc)


def first_n(n_fail: int, exc) -> Schedule:
    """Fail the first ``n_fail`` calls, then heal."""
    return lambda n: Fail(exc) if n < n_fail else None


def flap(fail_n: int, ok_n: int, exc) -> Schedule:
    """``fail_n`` failures, ``ok_n`` successes, repeated."""
    period = fail_n + ok_n
    return lambda n: Fail(exc) if n % period < fail_n else None


def latency(seconds: float, every: int = 1) -> Schedule:
    """``seconds`` of latency on every ``every``-th call."""
    return lambda n: Latency(seconds) if n % every == 0 else None


def seeded(seed: int, p_fail: float, exc) -> Schedule:
    """Failures that are a pure function of (seed, n)."""
    return lambda n: (Fail(exc) if random.Random(seed * 1_000_003 + n).random() < p_fail
                      else None)


class FaultInjector:
    """Point -> schedule, with per-point call counters."""

    def __init__(self):
        self._schedules: Dict[str, Schedule] = {}
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def install(self, point: str, schedule: Schedule) -> None:
        with self._lock:
            self._schedules[point] = schedule
            self._counts[point] = 0

    def uninstall(self, point: str) -> None:
        with self._lock:
            self._schedules.pop(point, None)

    def clear(self) -> None:
        with self._lock:
            self._schedules.clear()
            self._counts.clear()

    def calls(self, point: str) -> int:
        with self._lock:
            return self._counts.get(point, 0)

    def _outcome(self, point: str) -> Outcome:
        with self._lock:
            schedule = self._schedules.get(point)
            if schedule is None:
                return None
            n = self._counts.get(point, 0)
            self._counts[point] = n + 1
        return schedule(n)

    def fire(self, point: str) -> None:
        """Executor-thread site. The unlocked empty-dict read is the fast
        exit; a racing ``install`` is seen one call late."""
        if not self._schedules:  # ompb-lint: disable=lock-discipline -- the fast exit with chaos off: an unlocked emptiness read, and a racing install is seen one call late
            return
        outcome = self._outcome(point)
        if outcome is None:
            return
        note_fault(point)
        if isinstance(outcome, Latency):
            # latency models a slow dependency: sleeping on the event-loop
            # thread would stall every lane instead, so that misuse raises
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                pass
            else:
                raise RuntimeError(f"FaultInjector.fire({point!r}) would sleep on the "
                                   "event-loop thread; use fire_async() at coroutine sites")
            time.sleep(outcome.seconds)
            return
        outcome.raise_()

    async def fire_async(self, point: str) -> None:
        """Coroutine site: latency awaits."""
        if not self._schedules:  # ompb-lint: disable=lock-discipline -- the fast exit with chaos off: an unlocked emptiness read, and a racing install is seen one call late
            return
        outcome = self._outcome(point)
        if outcome is None:
            return
        note_fault(point)
        if isinstance(outcome, Latency):
            await asyncio.sleep(outcome.seconds)
            return
        outcome.raise_()


INJECTOR = FaultInjector()
