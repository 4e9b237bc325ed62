"""Batcher and encode queue: lanes in a device encode group, over the
groups the window completed (``/healthz`` ``queue``)."""


def read(ctx):
    groups = ctx.healthz_delta("queue.completed")
    lanes = ctx.healthz_delta("queue.lanes")
    if not groups or lanes is None:
        return None
    return lanes / groups
