"""Batcher and encode queue: the CPU the encode queue's two threads got
while they worked, as a share of their work's wall time (``/healthz``
``queue.threads.{submit,readback}.cpu_ms`` over ``wall_ms``); under 100 %
the threads waited to run (the GIL, a core, the driver, I/O)."""

THREADS = ("submit", "readback")


def read(ctx):
    cpu = [ctx.healthz_delta(f"queue.threads.{t}.cpu_ms") for t in THREADS]
    wall = [ctx.healthz_delta(f"queue.threads.{t}.wall_ms") for t in THREADS]
    if None in cpu or None in wall or sum(wall) <= 0:
        return None
    return sum(cpu) / sum(wall) * 100.0
