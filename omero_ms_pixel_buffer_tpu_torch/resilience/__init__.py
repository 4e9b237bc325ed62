"""Resilience layer (counterpart of ``omero_ms_pixel_buffer_tpu/
resilience/`` without ``timeouts.py``): request deadlines
(``deadline.py``), jittered-exponential retries (``retry.py``),
per-dependency circuit breakers (``breaker.py``), the executing-slot
counter (``admission.py``), the SLO scheduler (``scheduler.py``) and
deterministic fault injection (``faultinject.py``)."""
