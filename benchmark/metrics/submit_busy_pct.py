"""Batcher and encode queue: the share of the window the encode queue's
submit thread spent working, its explicit waits left out (``/healthz``
``queue.threads.submit.wall_ms``)."""


def read(ctx):
    ms = ctx.healthz_delta("queue.threads.submit.wall_ms")
    if ms is None or ctx.window_s <= 0:
        return None
    return ms / (ctx.window_s * 1e3) * 100.0
