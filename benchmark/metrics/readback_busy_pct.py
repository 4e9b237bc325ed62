"""Batcher and encode queue: the share of the window the encode queue's
readback thread spent working, its event waits and the mesh's
synchronise left out (``/healthz`` ``queue.threads.readback.wall_ms``)."""


def read(ctx):
    ms = ctx.healthz_delta("queue.threads.readback.wall_ms")
    if ms is None or ctx.window_s <= 0:
        return None
    return ms / (ctx.window_s * 1e3) * 100.0
