"""Kernels: the PNG filter kernel's share of its roofline. Its bound is
bytes: each lane's pixels read once, (rows, row bytes), and its filtered
scanlines written once, (rows, 1 + row bytes), at the device's memory
rate, for the lanes the window's encode groups carried (``/healthz``
``queue.lanes``), at the mean shape of the requests sent in the window.
The time is the kernel's summed device time in the trace
(``filter_row_groups``)."""

KERNEL = "filter_row_groups"


def read(ctx):
    if ctx.trace is None or not ctx.requests:
        return None
    seconds = ctx.trace.op_seconds(KERNEL)
    lanes = ctx.healthz_delta("queue.lanes")
    rate = ctx.peak("hbm_bytes_per_s")
    if seconds <= 0 or not lanes or not rate:
        return None
    per_lane = sum(rows * (2 * row_bytes + 1) for rows, row_bytes in
                   (r["lane"] for r in ctx.requests)) / len(ctx.requests)
    return lanes * per_lane / rate / seconds * 100.0
