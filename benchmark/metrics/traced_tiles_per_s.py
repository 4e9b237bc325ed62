"""Tiles a second in the traced run: answers of the window that came
back 200 before it closed, over all of its seconds (the client's clock),
with the server's profiler on. Their bodies are judged by ``correct``.
A per-layer metric: the host's own speed moves runs of one seed by more
than an end-to-end bound can hold."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return sum(1 for r in ctx.requests if r["status"] == 200 and r["done_in_window"]) / ctx.window_s
