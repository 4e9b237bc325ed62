"""Front and scheduler: milliseconds a request of the window waited for
its grant (``queue_wait``) and for its batch to start (``batch_wait``),
from the flight recorder's ``request_stage_seconds``, over the requests
the window completed (``http_request_seconds``)."""


def read(ctx):
    n = ctx.metric_delta("http_request_seconds_count")
    if n <= 0:
        return None
    wait = (ctx.metric_delta("request_stage_seconds_sum", stage="queue_wait")
            + ctx.metric_delta("request_stage_seconds_sum", stage="batch_wait"))
    return wait / n * 1e3
