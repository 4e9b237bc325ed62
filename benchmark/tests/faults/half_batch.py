"""Fault for the harness's test: half of each batch left out. The
pipeline answers only the first half of the lanes of a batch; the rest
get no tile (404)."""

from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import TilePipeline

_handle_batch = TilePipeline.handle_batch


def handle_batch(self, ctxs, defer=False):
    out = list(_handle_batch(self, ctxs, defer))
    half = len(out) // 2
    return out[:len(out) - half] + [None] * half


TilePipeline.handle_batch = handle_batch
