"""Jittered-exponential retry with a sleep budget, bounded by the caller's
deadline (copy of ``omero_ms_pixel_buffer_tpu/resilience/retry.py``).

Attempts back off exponentially with multiplicative jitter, the total
sleep of one call's sequence is capped by the policy's budget, and no
attempt or backoff starts past the ambient request deadline. The jitter
comes from a ``random.Random``: the caller's, or the module's. Retries and
abandoned sequences are counted per dependency: ``resilience_retries_total``
and ``resilience_retry_budget_exhausted_total`` on ``/metrics``,
``snapshot`` on ``/healthz``.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Dict, Optional, Tuple, Type

from ..utils.metrics import REGISTRY
from .deadline import Deadline, DeadlineExceeded, current_deadline

RETRIES = REGISTRY.counter(
    "resilience_retries_total", "Retry attempts by dependency"
)
RETRY_BUDGET_EXHAUSTED = REGISTRY.counter(
    "resilience_retry_budget_exhausted_total",
    "Retry sequences abandoned because the sleep budget ran out",
)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` counts the first call: 3 means up to 2 retries.
    ``budget_s`` caps the cumulative sleep of one call's retries;
    ``jitter`` subtracts up to that fraction of each delay."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    budget_s: float = 5.0

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        d = min(self.max_delay_s, self.base_delay_s * (self.multiplier ** (attempt - 1)))
        if self.jitter > 0:
            d *= 1.0 - self.jitter * rng.random()
        return d


DEFAULT_POLICY = RetryPolicy()


def set_default_policy(policy: RetryPolicy) -> None:
    """The process-wide policy (the YAML ``resilience.retry`` block,
    applied by ``resilience.configure``)."""
    global DEFAULT_POLICY
    DEFAULT_POLICY = policy

_rng = random.Random()


def _by_dependency(counter) -> Dict[str, int]:
    return {dict(k)["dependency"]: int(v) for k, v in counter.samples().items()}


def snapshot() -> dict:
    """Retries and abandoned sequences per dependency (``/healthz``)."""
    return {"retries": _by_dependency(RETRIES),
            "budget_exhausted": _by_dependency(RETRY_BUDGET_EXHAUSTED)}


def retry_call(
    fn: Callable,
    *,
    retryable: Tuple[Type[BaseException], ...] = (Exception,),
    deadline: Optional[Deadline] = None,
    name: str = "",
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> object:
    """Call ``fn`` with bounded, deadline-aware retries under
    ``DEFAULT_POLICY`` (the JAX defaults unless ``resilience.retry`` set
    another). ``deadline`` defaults to the
    ambient one; when it cannot cover the next backoff the sequence ends
    with ``DeadlineExceeded`` instead of sleeping past the caller."""
    policy = DEFAULT_POLICY
    rng = rng or _rng
    if deadline is None:
        deadline = current_deadline()
    dependency = name or "unknown"
    slept = 0.0
    attempt = 0
    while True:
        if deadline is not None:
            deadline.check(name or "retry")
        attempt += 1
        try:
            return fn()
        except retryable as e:
            if attempt >= policy.max_attempts:
                raise
            delay = policy.delay(attempt, rng)
            if slept + delay > policy.budget_s:
                RETRY_BUDGET_EXHAUSTED.inc(dependency=dependency)
                raise
            if deadline is not None and deadline.remaining() < delay:
                # sleeping would outlive the caller
                raise DeadlineExceeded(name or "retry backoff") from e
            RETRIES.inc(dependency=dependency)
            sleep(delay)
            slept += delay
