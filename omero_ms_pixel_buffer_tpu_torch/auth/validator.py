"""The session-validator interface (a copy of ``omero_ms_pixel_buffer_tpu/
auth/validator.py``; the OmeroRequest join contract,
PixelBufferVerticle.java:106-110): a key validates iff the OMERO
session it names is alive; invalid -> 403 at the dispatch layer."""

from __future__ import annotations

from typing import Optional


class SessionValidator:
    async def validate(self, omero_session_key: Optional[str]) -> bool:
        raise NotImplementedError
