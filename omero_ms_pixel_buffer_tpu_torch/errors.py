"""Failure taxonomy (copy of ``omero_ms_pixel_buffer_tpu/errors.py``'s
classes this slice serves): a failure carries the HTTP status the front
answers with."""

from __future__ import annotations


class TileError(Exception):
    """A failure with an HTTP-ish failure code."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class BadRequestError(TileError):
    """400 — unparseable parameter."""

    def __init__(self, message: str):
        super().__init__(400, message)


class PermissionDeniedError(TileError):
    """403 — no or unknown session."""

    def __init__(self, message: str = "Permission denied"):
        super().__init__(403, message)


class NotFoundError(TileError):
    """404 — image missing, or the pipeline returned nothing."""

    def __init__(self, message: str):
        super().__init__(404, message)


class InternalError(TileError):
    """500 — any other failure, including a failed device encode group."""

    def __init__(self, message: str = "Exception while retrieving tile"):
        super().__init__(500, message)


class RequestTooLargeError(TileError):
    """413 — the request describes more pixel bytes than the service
    will materialize (``max_tile_bytes``): a z/t-projection whose whole
    stack exceeds the budget even though each plane fits."""

    def __init__(self, message: str = "Request exceeds max-tile-bytes"):
        super().__init__(413, message)


class GatewayTimeoutError(TileError):
    """504 — the request's deadline expired before a tile was produced."""

    def __init__(self, message: str = "Request deadline exceeded"):
        super().__init__(504, message)
