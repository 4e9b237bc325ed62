"""Batcher and encode queue: milliseconds an encode group waited in the
queue, for the submit thread (``submit_wait``), an in-flight slot
(``slot_wait``) and the readback thread (``readback_wait``), over the
groups the window completed (``/healthz`` ``queue.stage_ms_total`` and
``queue.completed``)."""

WAITS = ("submit_wait", "slot_wait", "readback_wait")


def read(ctx):
    groups = ctx.healthz_delta("queue.completed")
    ms = [ctx.healthz_delta(f"queue.stage_ms_total.{w}") for w in WAITS]
    if not groups or None in ms:
        return None
    return sum(ms) / groups
