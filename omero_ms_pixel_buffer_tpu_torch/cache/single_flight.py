"""Single-flight coalescing (counterpart of
``omero_ms_pixel_buffer_tpu/cache/single_flight.py``): concurrent callers
with one key share one execution. The first caller's factory runs as a
task; later callers await the same task, an error reaches every waiter,
and a waiter that gives up never cancels the flight."""

from __future__ import annotations

import asyncio
from typing import Any, Awaitable, Callable, Dict

from ..utils.metrics import REGISTRY

FLIGHTS = REGISTRY.counter(
    "tile_cache_flights_total",
    "Single-flight participations by role (leader starts an execution;"
    " a joiner shares one already in flight)",
)


class SingleFlight:
    """Per-key coalescer on one event loop."""

    def __init__(self):
        self._flights: Dict[Any, asyncio.Task] = {}

    async def do(self, key: Any, factory: Callable[[], Awaitable[Any]]) -> Any:
        """The (possibly shared) result of ``factory()`` for ``key``."""
        task = self._flights.get(key)
        if task is None:
            task = asyncio.get_running_loop().create_task(self._lead(key, factory))
            # consume the exception when every waiter has gone
            task.add_done_callback(lambda t: t.cancelled() or t.exception())
            self._flights[key] = task
            FLIGHTS.inc(role="leader")
        else:
            FLIGHTS.inc(role="joiner")
        return await asyncio.shield(task)

    async def _lead(self, key: Any, factory) -> Any:
        try:
            return await factory()
        finally:
            # deregister before waiters resume: a later miss starts a new flight
            self._flights.pop(key, None)
