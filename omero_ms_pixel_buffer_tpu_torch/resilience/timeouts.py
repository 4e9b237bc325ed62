"""Per-call network timeouts for the remote-I/O edges (a copy of
``omero_ms_pixel_buffer_tpu/resilience/timeouts.py``, the PyTorch port's
own: it imports nothing of the JAX package).

The breaker and fault-injection layer made *failing*
dependencies cheap, but a dependency that simply stops answering
still parked each caller until the transport noticed or the request
deadline fired — on an edge without its own clock (the Postgres and
Redis wire clients) that could be the WHOLE request budget spent
inside one exchange. One
process-wide per-call cap bounds every single network exchange:

- ``db/postgres.py``  — one extended-query round trip (incl. connect)
- ``auth/stores.py``  — one Redis session lookup (incl. connect)
- ``auth/ice.py``     — each Glacier2 message (connect / read / write)

The cap composes with, never replaces, the end-to-end request
deadline: a request's budget still bounds the sum; this bounds each
term. Configured by ``resilience.io-timeout-ms`` (0 disables);
``resilience.configure()`` applies it at startup. The ompb-lint
``resilience-coverage`` rule enforces the invariant going forward:
every network primitive in scope must have a timeout on a caller
path.
"""

from __future__ import annotations

import threading

DEFAULT_IO_TIMEOUT_S = 5.0

_lock = threading.Lock()
_io_timeout_s = DEFAULT_IO_TIMEOUT_S


def set_io_timeout(seconds: float) -> None:
    """Process-wide per-call cap; <= 0 disables (deadline-only)."""
    global _io_timeout_s
    with _lock:
        _io_timeout_s = float(seconds)


def io_timeout_s() -> float:
    with _lock:
        return _io_timeout_s
