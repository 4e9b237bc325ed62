"""Body bytes of a 200 answer of the window, on average: what a tile
costs on the wire (a cheaper deflate would show here)."""


def read(ctx):
    ok = [r["bytes"] for r in ctx.requests if r["status"] == 200]
    return sum(ok) / len(ok) if ok else None
