"""The server's process: the port's own entry point
(``python -m omero_ms_pixel_buffer_tpu_torch --config ... --dev``) with
two signals added for the benchmark.

- SIGUSR1 opens the measured window. With ``--trace 1`` it starts a
  ``torch.profiler`` window (CPU and CUDA activity) and a sampler of the
  host threads' stacks, which labels the device's idle gaps.
- SIGUSR2 closes it: the profiler stops and its Chrome trace is written
  to ``--work``, and ``closed.json`` reports the device, the peak of
  device memory and any JAX module loaded in this process.

Usage: launcher.py --work DIR --trace 0|1 [--preload FILE] -- ARGS
(``ARGS`` go to the port's entry point; ``--preload`` runs a Python
file first, which tests use to break the program on purpose)."""

from __future__ import annotations

import argparse
import json
import os
import runpy
import signal
import sys
import threading
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "omero_ms_pixel_buffer_tpu")
SAMPLE_S = 0.002
PORT = "omero_ms_pixel_buffer_tpu_torch"
# innermost frames of a thread that waits rather than works
_WAITING = ("threading.py", "queue.py", "selectors.py", "socket.py", "thread.py",
            "asyncio/base_events.py", "_base.py", "connection.py")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (the port's name begins with the latter's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _label(frame) -> str:
    """``module:function`` of the innermost frame of the port, else of the
    innermost frame."""
    inner = frame
    while frame is not None:
        path = frame.f_code.co_filename
        if PORT in path:
            mod = path.rsplit(PORT, 1)[1].lstrip("/").removesuffix(".py")
            return f"{mod}:{frame.f_code.co_name}"
        frame = frame.f_back
    return f"{os.path.basename(inner.f_code.co_filename)}:{inner.f_code.co_name}"


class Sampler(threading.Thread):
    """Every ``SAMPLE_S``, the label of each host thread that is working
    (its innermost frame is not a wait): [[time.monotonic(), label], ...]."""

    def __init__(self):
        super().__init__(name="bench-sampler", daemon=True)
        self.samples, self.stop = [], threading.Event()

    def run(self) -> None:
        me = threading.get_ident()
        while not self.stop.wait(SAMPLE_S):
            now = time.monotonic()
            for ident, frame in sys._current_frames().items():
                if ident == me or frame.f_code.co_filename.endswith(_WAITING):
                    continue
                self.samples.append([now, _label(frame)])


class Window:
    def __init__(self, work: str, trace: bool):
        self.work, self.trace = work, trace
        self.prof = self.sampler = None
        self.marks = {}

    def _mark(self, name: str) -> None:
        """A profiler range stamped with ``time.monotonic()``: the trace's
        clock against the host's."""
        import torch

        t0 = time.monotonic()
        with torch.profiler.record_function(f"bench.{name}"):
            pass
        self.marks[name] = [t0, time.monotonic()]

    def open(self, *_):
        if self.trace:
            import torch
            from torch.profiler import ProfilerActivity

            self.prof = torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self._mark("open")
            self.sampler = Sampler()
            self.sampler.start()
        _write(os.path.join(self.work, "opened.json"), {"at": time.monotonic()})

    def close(self, *_):
        import torch

        out = {"at": time.monotonic()}
        if self.prof is not None:
            self.sampler.stop.set()
            self.sampler.join()
            self._mark("close")
            self.prof.stop()
            self.prof.export_chrome_trace(os.path.join(self.work, "trace.json"))
            out.update(marks=self.marks, samples=self.sampler.samples)
            self.prof = None
        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        out.update(
            device_kind=torch.cuda.get_device_name(0) if cuda else "cpu",
            memory_peak_bytes=int(torch.cuda.max_memory_allocated(0)) if cuda else 0,
            forbidden=forbidden_modules(),
        )
        _write(os.path.join(self.work, "closed.json"), out)


def _write(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    split = argv.index("--")
    p = argparse.ArgumentParser()
    p.add_argument("--work", required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--preload", default=None)
    args = p.parse_args(argv[:split])
    window = Window(args.work, bool(args.trace))
    signal.signal(signal.SIGUSR1, window.open)
    signal.signal(signal.SIGUSR2, window.close)
    if args.preload:
        runpy.run_path(args.preload, run_name="bench_preload")
    from omero_ms_pixel_buffer_tpu_torch.__main__ import main as serve

    return serve(argv[split + 1:])


if __name__ == "__main__":
    sys.exit(main())
