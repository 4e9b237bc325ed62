"""Front and scheduler: milliseconds of a request's time at the door that
no flight-recorder stage claimed (the port's ``request_unclaimed_seconds``,
total minus the stage sums; the hand-off is part of it), over the requests
the window completed (``http_request_seconds``)."""


def read(ctx):
    n = ctx.metric_delta("http_request_seconds_count")
    if n <= 0 or not any(name == "request_unclaimed_seconds_sum"
                         for name, _ in ctx.metrics_after):
        return None
    return ctx.metric_delta("request_unclaimed_seconds_sum") / n * 1e3
