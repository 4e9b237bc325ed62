"""Device: milliseconds of device time an encode group took, from CUDA
timing events around its device work (one-pass, both passes of a
``dynamic`` group, render, mesh), over the groups timed in the window
(``/healthz`` ``queue.device_ms_total`` by kind and
``queue.device_groups``)."""

KINDS = ("tiles", "dynamic_pass1", "dynamic_pass2", "render", "mesh")


def read(ctx):
    groups = ctx.healthz_delta("queue.device_groups")
    ms = [ctx.healthz_delta(f"queue.device_ms_total.{k}") for k in KINDS]
    if not groups or None in ms:
        return None
    return sum(ms) / groups
