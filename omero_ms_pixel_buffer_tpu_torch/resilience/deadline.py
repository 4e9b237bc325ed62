"""Request deadlines (the part of ``omero_ms_pixel_buffer_tpu/resilience/
deadline.py`` the read plane uses).

A ``Deadline`` is a monotonic expiry point; the ambient one is a context
variable that store retries and the fetch planner consult so that no
backoff outlives its caller. The port's front sets none yet (it has no
scheduler), so ``current_deadline()`` is None on every request and the
read plane's limits are its own: the retry budget and the per-call
timeouts.
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

from ..errors import GatewayTimeoutError


class DeadlineExceeded(GatewayTimeoutError):
    """Work attempted past its request budget (-> 504)."""

    def __init__(self, what: str = ""):
        detail = f" ({what})" if what else ""
        super().__init__(f"Request deadline exceeded{detail}")


class Deadline:
    """A monotonic expiry point; ``clock`` is injectable for tests."""

    __slots__ = ("expires_at", "clock")

    def __init__(self, expires_at: float, clock=time.monotonic):
        self.expires_at = expires_at
        self.clock = clock

    def remaining(self) -> float:
        """Seconds left, floored at 0."""
        return max(0.0, self.expires_at - self.clock())

    @property
    def expired(self) -> bool:
        return self.clock() >= self.expires_at

    def check(self, what: str = "") -> None:
        """Raise ``DeadlineExceeded`` if the budget is spent."""
        if self.expired:
            raise DeadlineExceeded(what)


_current_deadline: contextvars.ContextVar[Optional[Deadline]] = (
    contextvars.ContextVar("resilience_deadline", default=None)
)


def current_deadline() -> Optional[Deadline]:
    """The ambient deadline, or None outside a request scope."""
    return _current_deadline.get()
