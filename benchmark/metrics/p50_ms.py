"""Median latency of every request sent in the window, client side (a
failed request counts as missing: the longest wait for an answer)."""

from harness.context import percentile


def read(ctx):
    return percentile([r["latency_ms"] for r in ctx.requests], 0.50)
