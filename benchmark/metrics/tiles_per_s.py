"""Tiles a second: answers of the window that came back 200 before it
closed, over all of its seconds (the client's clock). Their bodies are
judged by ``correct``."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return sum(1 for r in ctx.requests if r["status"] == 200 and r["done_in_window"]) / ctx.window_s
