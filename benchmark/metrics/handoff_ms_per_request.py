"""Front and scheduler: milliseconds a finished answer waited for the
serving loop, from the worker thread where it came to exist (a batch's
return, or a deferred lane's group resolving on the readback thread) to
the request's coroutine resuming (the port's ``request_handoff_seconds``),
over the answers that passed the batcher in the window."""


def read(ctx):
    n = ctx.metric_delta("request_handoff_seconds_count")
    if n <= 0:
        return None
    return ctx.metric_delta("request_handoff_seconds_sum") / n * 1e3
