"""Resilience layer of the read plane (counterpart of the parts of
``omero_ms_pixel_buffer_tpu/resilience/`` that the stores and the fetch
planner use): request deadlines (``deadline.py``), jittered-exponential
retries (``retry.py``) and per-dependency circuit breakers
(``breaker.py``). The scheduler, admission control and fault injection
are not ported yet."""
