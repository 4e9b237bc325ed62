"""Resilience layer (counterpart of ``omero_ms_pixel_buffer_tpu/
resilience/``): request deadlines (``deadline.py``), jittered-exponential
retries (``retry.py``), per-dependency circuit breakers (``breaker.py``),
the executing-slot counter (``admission.py``), the SLO scheduler
(``scheduler.py``), the per-call network cap (``timeouts.py``) and
deterministic fault injection (``faultinject.py``). ``configure`` applies
the YAML ``resilience:`` block process-wide."""

from __future__ import annotations


def configure(res_config) -> None:
    """Apply a ``utils.config.ResilienceConfig`` to the process-wide
    defaults: the breaker board, the default retry policy and the
    per-call I/O timeout (the JAX ``resilience.configure``)."""
    from .breaker import BOARD
    from .retry import RetryPolicy, set_default_policy
    from .timeouts import set_io_timeout

    b = res_config.breaker
    BOARD.configure(
        enabled=res_config.enabled,
        failure_threshold=b.failure_threshold,
        failure_rate_threshold=b.failure_rate_threshold,
        window=b.window,
        min_calls=b.min_calls,
        open_duration_s=b.open_duration_ms / 1000.0,
        half_open_probes=b.half_open_probes,
        slow_call_duration_s=b.slow_call_duration_ms / 1000.0,
        slow_call_rate_threshold=b.slow_call_rate_threshold,
    )
    r = res_config.retry
    set_default_policy(RetryPolicy(
        max_attempts=r.max_attempts,
        base_delay_s=r.base_delay_ms / 1000.0,
        max_delay_s=r.max_delay_ms / 1000.0,
        jitter=r.jitter,
        budget_s=r.budget_ms / 1000.0,
    ))
    set_io_timeout(res_config.io_timeout_ms / 1000.0)
