"""End-to-end request deadlines (copy of ``omero_ms_pixel_buffer_tpu/
resilience/deadline.py``).

A request's budget is minted once at the HTTP front as a ``Deadline`` and
carried on the ``TileCtx``: the scheduler's wait, the batcher, the
pipeline's stages, store retries and the fetch planner all decrement the
same clock, so no retry or backoff outlives its caller. On the wire a
deadline is its remaining budget in ms (absolute monotonic times do not
cross processes). The ambient deadline is a context variable the batcher
sets around each batch's executor work (``deadline_scope``); synchronous
depths read it with ``current_deadline``.

Expiries are counted by the stage that noticed them (``note_exceeded``):
``resilience_deadline_exceeded_total`` on ``/metrics`` and ``snapshot`` on
``/healthz``.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Dict, Optional

from ..errors import GatewayTimeoutError
from ..utils.metrics import REGISTRY

DEADLINE_EXCEEDED = REGISTRY.counter(
    "resilience_deadline_exceeded_total",
    "Requests that ran out of budget, by the stage that noticed",
)


def note_exceeded(stage: str) -> None:
    """Count one request that ran out of budget at ``stage``."""
    DEADLINE_EXCEEDED.inc(stage=stage)


def snapshot() -> Dict[str, int]:
    """Expired requests by the stage that noticed (``/healthz``)."""
    return {dict(k)["stage"]: int(v) for k, v in DEADLINE_EXCEEDED.samples().items()}


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

    @classmethod
    def after(cls, budget_s: float, clock=time.monotonic) -> "Deadline":
        return cls(clock() + budget_s, clock)

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

    def cap(self, timeout_s: Optional[float]) -> float:
        """A per-call timeout bounded by the remaining budget."""
        rem = self.remaining()
        return rem if timeout_s is None else min(timeout_s, rem)

    def to_json(self) -> dict:
        """The remaining budget: a hop re-mints the deadline from what is
        left, so transit time is charged to the request."""
        return {"budgetMs": self.remaining() * 1000.0}

    @classmethod
    def from_json(cls, obj: Optional[dict]) -> Optional["Deadline"]:
        if not obj or obj.get("budgetMs") is None:
            return None
        return cls.after(float(obj["budgetMs"]) / 1000.0)


_current_deadline: contextvars.ContextVar[Optional[Deadline]] = (
    contextvars.ContextVar("resilience_deadline", default=None)
)


def current_deadline() -> Optional[Deadline]:
    """The ambient deadline, or None outside a request scope."""
    return _current_deadline.get()


@contextlib.contextmanager
def deadline_scope(deadline: Optional[Deadline]):
    """Make ``deadline`` ambient for the block (and, through
    ``contextvars.copy_context``, for executor work started inside it)."""
    token = _current_deadline.set(deadline)
    try:
        yield deadline
    finally:
        _current_deadline.reset(token)
