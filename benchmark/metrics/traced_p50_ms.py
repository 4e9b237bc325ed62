"""Median latency of every request sent in the traced run's window,
client side, with the server's profiler on (a failed request counts as
missing: the longest wait for an answer). A per-layer metric for the
same reason as ``traced_tiles_per_s``."""

from harness.context import percentile


def read(ctx):
    return percentile([r["latency_ms"] for r in ctx.requests], 0.50)
