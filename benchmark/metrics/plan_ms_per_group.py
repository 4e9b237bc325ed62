"""Deflate chain: milliseconds of the host Huffman plan (``dynamic``
mode, on the readback thread) a group, over the window (``/healthz``
``queue.stage_ms_total.plan`` and ``stage_groups.plan``)."""


def read(ctx):
    groups = ctx.healthz_delta("queue.stage_groups.plan")
    ms = ctx.healthz_delta("queue.stage_ms_total.plan")
    if not groups or ms is None:
        return None
    return ms / groups
