"""Interactive session plane (counterpart of
``omero_ms_pixel_buffer_tpu/session/``): the live edge the pull surfaces
terminate on.

- ``channels`` — the bounded registry of live viewer channels
  (WebSocket with SSE fallback, ``GET /session/{imageId}/live``).
  Every purge of an image becomes a ``{"tiles": [...], "epoch": N}``
  delta frame to each subscribed channel, so open viewports re-fetch
  changed tiles instead of waiting out TTLs. Channels report their real
  viewport geometry, which supersedes the prefetcher's fixed
  ``viewport-span`` band.
- ``annotations`` — the bounded per-image annotation store whose shapes
  are the render plane's ROI grammar (``render/masks.ShapeSpec``):
  overlays composite through the mask raster path and share cache
  entries and ETags with explicit ``roi=`` requests. Writes bump a
  sub-epoch and push deltas to subscribers.

Registries are bounded, and pushes stamp the flight recorder so a slow
channel is a kept trace.
"""

from .annotations import AnnotationStore
from .channels import ChannelRegistry, SessionChannel

__all__ = ["AnnotationStore", "ChannelRegistry", "SessionChannel"]
