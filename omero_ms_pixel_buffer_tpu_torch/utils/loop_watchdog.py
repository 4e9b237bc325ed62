"""Event-loop lag watchdog (copy of ``omero_ms_pixel_buffer_tpu/utils/
loop_watchdog.py``): the lag goes to ``/metrics`` (``event_loop_*``) and to
``snapshot`` (``/healthz`` ``watchdog``).

A heartbeat coroutine on the watched loop sleeps ``interval_s`` and
measures how much later than scheduled it ran: that overshoot is the loop
lag. A checker daemon thread declares the loop blocked when no beat lands
within ``warn_after_s`` and logs the loop thread's current stack, once
per stall, and once more on recovery.
"""

from __future__ import annotations

import asyncio
import logging
import sys
import threading
import time
import traceback
from typing import Optional

from .metrics import REGISTRY

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.loop_watchdog")

# the JAX package's resilience.watchdog defaults
INTERVAL_S = 0.1
WARN_AFTER_S = 1.0

LOOP_LAG = REGISTRY.histogram(
    "event_loop_lag_seconds",
    "How much later than scheduled the event-loop heartbeat ran",
)
LOOP_BLOCKED = REGISTRY.counter(
    "event_loop_blocked_total",
    "Stalls where the event loop missed the blocked threshold",
)
LOOP_MAX_LAG = REGISTRY.gauge(
    "event_loop_max_lag_seconds",
    "Largest heartbeat lag observed since start",
)


class LoopWatchdog:
    """Watch one asyncio loop. ``start()`` runs on the loop's thread;
    ``stop()`` anywhere."""

    def __init__(self, interval_s: float = INTERVAL_S, warn_after_s: float = WARN_AFTER_S):
        self.interval_s = interval_s
        self.warn_after_s = warn_after_s
        self._task: Optional[asyncio.Task] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread_id: Optional[int] = None
        # (last beat, last lag): one tuple, swapped atomically under the GIL
        self._beat = (time.monotonic(), 0.0)
        self._max_lag_s = 0.0
        self._blocked_since: Optional[float] = None
        self._blocked_events = 0

    def start(self, loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
        if self._task is not None:
            return
        loop = loop or asyncio.get_running_loop()
        self._loop = loop
        self._loop_thread_id = threading.get_ident()
        self._stop.clear()
        self._beat = (time.monotonic(), 0.0)
        self._task = loop.create_task(self._heartbeat())
        self._thread = threading.Thread(target=self._check, name="loop-watchdog", daemon=True)
        self._thread.start()

    async def _heartbeat(self) -> None:
        while not self._stop.is_set():
            t0 = time.monotonic()
            await asyncio.sleep(self.interval_s)
            lag = max(0.0, time.monotonic() - t0 - self.interval_s)
            LOOP_LAG.observe(lag)
            if lag > self._max_lag_s:
                self._max_lag_s = lag
                LOOP_MAX_LAG.set(lag)
            self._beat = (time.monotonic(), lag)

    def _check(self) -> None:
        # twice per threshold: detection within 1.5 x warn_after_s
        period = max(self.warn_after_s / 2.0, 0.01)
        while not self._stop.wait(period):
            last_beat, _ = self._beat
            stalled_s = time.monotonic() - last_beat - self.interval_s
            if stalled_s >= self.warn_after_s:
                if self._blocked_since is None:
                    self._blocked_since = last_beat
                    self._blocked_events += 1
                    LOOP_BLOCKED.inc()
                    log.warning("event loop blocked for >= %.0f ms; loop-thread stack:\n%s",
                                stalled_s * 1000, self._loop_stack())
            elif self._blocked_since is not None:
                duration = time.monotonic() - self._blocked_since
                self._blocked_since = None
                log.warning("event loop recovered after ~%.0f ms stall", duration * 1000)

    def _loop_stack(self) -> str:
        frame = sys._current_frames().get(self._loop_thread_id)
        if frame is None:
            return "<loop thread not found>"
        return "".join(traceback.format_stack(frame))

    def stop(self) -> None:
        self._stop.set()
        task, self._task = self._task, None
        if task is not None and self._loop is not None:
            if threading.get_ident() == self._loop_thread_id:
                task.cancel()
            elif not self._loop.is_closed():
                self._loop.call_soon_threadsafe(task.cancel)
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def snapshot(self) -> dict:
        """The ``/healthz`` view; ``stalled_ms`` is live, computed on the
        checker's side of the clock while the loop cannot beat."""
        last_beat, last_lag = self._beat
        stalled_s = max(0.0, time.monotonic() - last_beat - self.interval_s)
        return {
            "enabled": True,
            "last_lag_ms": round(last_lag * 1000, 2),
            "max_lag_ms": round(self._max_lag_s * 1000, 2),
            "stalled_ms": round(stalled_s * 1000, 2),
            "blocked": self._blocked_since is not None,
            "blocked_events": self._blocked_events,
            "blocked_threshold_ms": self.warn_after_s * 1000,
        }
