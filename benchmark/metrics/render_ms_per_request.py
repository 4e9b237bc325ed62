"""Render: milliseconds a request spent in the render stage (composite,
carve; flight recorder ``request_stage_seconds{stage="render"}``)."""


def read(ctx):
    n = ctx.metric_delta("request_stage_seconds_count", stage="render")
    if n <= 0:
        return None
    return ctx.metric_delta("request_stage_seconds_sum", stage="render") / n * 1e3
