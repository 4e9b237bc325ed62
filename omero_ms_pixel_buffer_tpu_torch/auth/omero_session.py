"""Per-request OMERO session validation (a copy of
``omero_ms_pixel_buffer_tpu/auth/omero_session.py``, the PyTorch port's
own: it imports nothing of the JAX package).

Replaces omero-ms-core's ``OmeroRequest``
(PixelBufferVerticle.java:106-110): the reference joins the OMERO
server session over Ice/Glacier2 per request; a bad key raises
PermissionDenied/CannotCreateSession -> 403.

The validator interface keeps that contract at the dispatch boundary.
Implementations:

- ``AllowListValidator`` — standalone/bench mode: a key is valid when
  the session store produced it (it came from an authenticated
  OMERO.web session) and matches the optional allow-set.
- ``IceSessionValidator`` (auth/ice.py, re-exported here) — the real
  Glacier2 join over the in-tree Ice-protocol client:
  ``createSession(key, key)`` against the OMERO router; denial -> 403.
"""

from __future__ import annotations

from typing import Iterable, Optional, Set

from .ice import IceSessionValidator  # noqa: F401  (re-export)
from .validator import SessionValidator  # noqa: F401  (re-export)


class AllowListValidator(SessionValidator):
    """Accepts any non-empty key (the store already authenticated the
    browser session), optionally restricted to an explicit allow-set."""

    def __init__(self, allowed: Optional[Iterable[str]] = None):
        self.allowed: Optional[Set[str]] = set(allowed) if allowed else None

    async def validate(self, omero_session_key: Optional[str]) -> bool:
        if not omero_session_key:
            return False
        if self.allowed is not None:
            return omero_session_key in self.allowed
        return True


