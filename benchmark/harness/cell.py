"""One run of one cell:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up (timed as ``setup_s``, from process start to the first timed
request): the image is made from the seed and written, the port's
server starts in a process of its own (``launcher.py``), and the
warm-up touches each plane until the plane cache holds it and runs
rounds of steps at every client. The load then keeps one core of this
process's set and the server the others. Then the measured window:
closed-loop clients for ``--seconds``; with ``--trace 1`` the server's
profiler covers exactly that window. After it the server stops, the answers are
judged (``check``), and the last line of standard output is the result
(with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics)."""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from harness import check, client, context, fixture, launcher, manifest, traffic
from harness.trace import Trace, clock_offset

PORT_PACKAGE = "omero_ms_pixel_buffer_tpu_torch"
START_TIMEOUT_S = 1100.0  # a checkout's first run builds the kernels
SIGNAL_TIMEOUT_S = 120.0
STOP_TIMEOUT_S = 30.0


class RunError(RuntimeError):
    """The run cannot give a result."""


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed is a whole number >= 0")
    return args


def chip_check(chips: int) -> None:
    """Fail unless this machine shows CUDA and at least ``chips`` cards
    (NVML's count: this process makes no CUDA context of its own)."""
    os.environ.setdefault("PYTORCH_NVML_BASED_CUDA_CHECK", "1")
    import torch

    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise RunError(f"{torch.cuda.device_count()} CUDA device(s), the cell asks for {chips}")


def free_port() -> int:
    with socket.socket() as s:
        s.bind((client.HOST, 0))
        return s.getsockname()[1]


def split_cores() -> tuple:
    """(the load's core, the server's cores): the load takes the last core
    of this process's set and the server the others, so that neither
    takes the other's time; (None, None) with fewer than two cores."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 2:
        return None, None
    return {cores[-1]}, set(cores[:-1])


class Server:
    """The launcher's process: the port's server with the window signals."""

    def __init__(self, root: Path, work: str, config_path: str, device: str,
                 trace: int, preload=None, cores=None, server_env=None):
        self.work, self.port = work, free_port()
        cmd = [sys.executable, str(Path(launcher.__file__)), "--work", work,
               "--trace", str(trace)]
        if preload:
            cmd += ["--preload", str(preload)]
        cmd += ["--", "--config", config_path, "--dev", "--device", device,
                "--host", client.HOST, "--port", str(self.port)]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        # the configuration's OMPB_* variables: this process's own
        # environment stays as it is
        env.update(server_env or {})
        self.err_path = os.path.join(work, "server.stderr")
        with open(self.err_path, "w") as err:
            # a process group of its own, so that stop() reaches whatever
            # the server starts (a kernel build's nvcc) as well
            self.proc = subprocess.Popen(
                cmd, cwd=root, env=env, stdout=subprocess.PIPE, stderr=err, text=True,
                process_group=0,
                preexec_fn=None if cores is None else lambda: os.sched_setaffinity(0, cores))
        self.lines: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def log(self) -> str:
        with open(self.err_path) as f:
            return f.read()[-4000:]

    def wait_listening(self) -> None:
        deadline = time.monotonic() + START_TIMEOUT_S
        while True:
            try:
                line = self.lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise RunError("the server did not start in time") from None
            if line is None:
                raise RunError(f"the server exited while starting:\n{self.log()}")
            if line.startswith("listening on"):
                return

    def _signal(self, sig, name: str) -> dict:
        path = os.path.join(self.work, name)
        self.proc.send_signal(sig)
        deadline = time.monotonic() + SIGNAL_TIMEOUT_S
        while not os.path.exists(path):
            if self.proc.poll() is not None or time.monotonic() > deadline:
                raise RunError(f"the server did not write {name}:\n{self.log()}")
            time.sleep(0.005)
        with open(path) as f:
            return json.load(f)

    def open_window(self) -> dict:
        return self._signal(signal.SIGUSR1, "opened.json")

    def close_window(self) -> dict:
        return self._signal(signal.SIGUSR2, "closed.json")

    def stop(self) -> None:
        """SIGINT, and SIGKILL to the whole group after a minute; then
        SIGKILL to whatever is left in the group, and a wait until no
        process of it is alive."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                _kill_group(self.proc.pid)
        try:
            self.proc.wait(STOP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise RunError("the server did not end after SIGKILL") from None
        _kill_group(self.proc.pid)
        deadline = time.monotonic() + STOP_TIMEOUT_S
        while _group_alive(self.proc.pid):
            if time.monotonic() > deadline:
                raise RunError("a process of the server's group did not end")
            time.sleep(0.01)


def _kill_group(pgid: int) -> None:
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def _group_alive(pgid: int) -> bool:
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return False
    return True


async def _one_step(port: int, stream, width: int) -> list:
    conns = [client.Connection(port, f"bench-warm-{stream.client}") for _ in range(width)]
    try:
        return await asyncio.gather(*(c.get(s) for c, s in zip(conns, stream.step())))
    finally:
        for c in conns:
            await c.close()


async def _warm(cell, port: int, seed: int) -> list:
    kind, config, mix = cell.kind, cell.config, cell.traffic
    seqs = traffic.touches(kind, config, mix, seed)
    answers = [a for r in await asyncio.gather(*(client.sequence(port, s) for s in seqs))
               for a in r]
    width = mix["cols"] * mix["rows"]
    for r in range(mix["warm_rounds"]):
        streams = [traffic.Client(kind, config, mix, seed, k, stream=traffic.STREAM_WARM + 10 * r)
                   for k in range(mix["clients"])]
        for res in await asyncio.gather(*(_one_step(port, s, width) for s in streams)):
            answers += res
    return answers


async def _snapshot(port: int) -> tuple:
    hz = json.loads(await client.fetch(port, "/healthz"))
    metrics = context.parse_prometheus((await client.fetch(port, "/metrics")).decode())
    return hz, metrics


async def _window(cell, port: int, seed: int, seconds: float, server: Server, start: float):
    t = time.monotonic()
    warm = await _warm(cell, port, seed)
    print(f"benchmark: warm-up {time.monotonic() - t:.2f} s", file=sys.stderr)
    before = await _snapshot(port)
    server.open_window()
    t0 = time.monotonic()
    t1 = t0 + seconds
    streams = [traffic.Client(cell.kind, cell.config, cell.traffic, seed, k)
               for k in range(cell.traffic["clients"])]

    async def at_close():
        await asyncio.sleep(max(0.0, t1 - time.monotonic()))
        return await _snapshot(port)

    width = cell.traffic["cols"] * cell.traffic["rows"]
    answers, after = await asyncio.gather(client.closed_loop(port, streams, t1, width),
                                          at_close())
    closed = server.close_window()
    return dict(setup_s=t0 - start, t0=t0, t1=t1, answers=answers, warm=warm,
                before=before, after=after, closed=closed)


def metrics(cell, w: dict, trace, chosen) -> dict:
    """The values of the ``chosen`` metrics, each from its reader; a reader
    that finds nothing to read leaves its metric out. ``setup_s`` is the
    harness's own."""
    t0, t1 = w["t0"], w["t1"]
    # an answer that failed counts as one that never came: as slow as the
    # longest wait for an answer
    missing_ms = client.ANSWER_TIMEOUT_S * 1e3
    sent = [dict(a.spec, lane=cell.kind.lane(cell.config, a.spec), status=a.status,
                 bytes=len(a.body) if a.body is not None else 0,
                 latency_ms=(a.done - a.sent) * 1e3 if a.status == 200 else missing_ms,
                 done_in_window=a.done <= t1)
            for a in w["answers"] if t0 <= a.sent < t1]
    ctx = context.Context(
        healthz_before=w["before"][0], healthz_after=w["after"][0],
        metrics_before=w["before"][1], metrics_after=w["after"][1],
        requests=sent, config=cell.config, traffic=cell.traffic, window_s=t1 - t0,
        trace=trace, device_kind=w["closed"]["device_kind"], peaks=context.load_peaks())
    out = {}
    for m in chosen:
        value = w["setup_s"] if m["name"] == "setup_s" else cell.readers[m["name"]].read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def load_trace(work: str, w: dict):
    closed = w["closed"]
    with open(os.path.join(work, "trace.json")) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    offset = clock_offset(closed["marks"], events)
    if offset is None:
        raise RunError("the trace has no bench.open range to align its clock")
    samples = [(t * 1e6 + offset, label) for t, label in closed["samples"]]
    return Trace(events, w["t0"] * 1e6 + offset, w["t1"] * 1e6 + offset, samples)


# /healthz counters whose change over the window is printed for the reader
DIAGNOSE = ("batcher.batches", "batcher.lanes", "batcher.lone", "queue.completed",
            "queue.lanes", "result_cache.memory.hits", "result_cache.memory.misses",
            "plane_cache.hits", "plane_cache.misses", "host_png_lanes",
            "supertile.stamped_lanes", "supertile.groups", "render.host_lanes")


def _diagnose(w: dict) -> None:
    """The window's counts, stage means and 200s a tenth of the window, on
    standard error (not metrics)."""
    tenth = (w["t1"] - w["t0"]) / 10
    bins = [0] * 10
    for a in w["answers"]:
        if a.status == 200 and w["t0"] <= a.done < w["t1"]:
            bins[min(9, int((a.done - w["t0"]) / tenth))] += 1
    print(f"benchmark: 200s by tenth of the window {bins}", file=sys.stderr)
    ctx = context.Context(w["before"][0], w["after"][0], w["before"][1], w["after"][1],
                          [], {}, {})
    counts = {k: ctx.healthz_delta(k) for k in DIAGNOSE}
    stages = {k: (ctx.healthz_delta(f"queue.stage_ms_total.{k}") or 0.0)
              / (ctx.healthz_delta(f"queue.stage_groups.{k}") or 1)
              for k in (w["after"][0].get("queue") or {}).get("stage_groups", {})}
    print(f"benchmark: window counts {json.dumps(counts)}; stage ms a group "
          f"{json.dumps(stages)}", file=sys.stderr)


def write_server_config(cell, work: str, registry: str) -> str:
    """The server's YAML (JSON is YAML): the configuration's server block
    and the image registry."""
    path = os.path.join(work, "server.yaml")
    with open(path, "w") as f:
        json.dump(dict(cell.config["server"], **{"image-registry": registry}), f, indent=1)
    return path


def run(argv, start: float, root: Path = manifest.ROOT, device: str = "cuda",
        require_chip: bool = True, preload=None) -> int:
    """One run; prints the result line. ``device``, ``require_chip`` and
    ``preload`` are for the CPU tests of the harness."""
    args = parse(argv)
    try:
        cell = manifest.resolve(args.workload, root)
        if not (root / PORT_PACKAGE).is_dir():
            raise RunError(f"no {PORT_PACKAGE} in the checkout")
        if require_chip:
            chip_check(cell.chips)
        img = cell.config["image"]
        with tempfile.TemporaryDirectory(prefix="bench-") as work:
            image = os.path.join(work, "image.ome.tiff")
            t = time.monotonic()
            source = fixture.write(image, img, cell.config["content"], args.seed,
                                   fixture.default_workers())
            print(f"benchmark: image {time.monotonic() - t:.2f} s, "
                  f"{os.path.getsize(image)} bytes", file=sys.stderr)
            registry = os.path.join(work, "registry.json")
            with open(registry, "w") as f:
                json.dump({"images": [{"id": img["id"], "path": image}]}, f)
            load_core, server_cores = split_cores()
            server = Server(root, work, write_server_config(cell, work, registry), device,
                            args.trace, preload, server_cores, cell.config.get("server_env"))
            if load_core:
                os.sched_setaffinity(0, load_core)
            try:
                t = time.monotonic()
                server.wait_listening()
                print(f"benchmark: server start {time.monotonic() - t:.2f} s", file=sys.stderr)
                w = asyncio.run(_window(cell, server.port, args.seed, args.seconds, server,
                                        start))
            finally:
                server.stop()
            trace = load_trace(work, w) if args.trace else None
            _diagnose(w)
            t = time.monotonic()
            # the warm-up's answers are judged too (their status and
            # format); a JPEG source's reference reads the image's file
            try:
                numbers = check.judge(w["warm"] + w["answers"], cell.kind, cell.config, source)
            finally:
                source.close()
            print(f"benchmark: check {time.monotonic() - t:.2f} s", file=sys.stderr)
        for example in numbers["examples"]:
            print(f"benchmark: wrong answer {example}", file=sys.stderr)
    except (RunError, manifest.ManifestError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = sorted(set(launcher.forbidden_modules()) | set(w["closed"]["forbidden"]))
    if found:
        print(f"benchmark: JAX modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    sent = [a for a in w["answers"] if w["t0"] <= a.sent < w["t1"]]
    failed = sum(1 for a in sent if a.status != 200)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": w["closed"]["device_kind"], "count": cell.chips,
           "memory_peak_bytes": w["closed"]["memory_peak_bytes"]}
    result = {"correct": check.verdict(numbers), "attempted": len(sent),
              "failed": failed,
              "metrics": metrics(cell, w, trace, cell.per_layer if args.trace else cell.end_to_end),
              "device": dev}
    if trace is not None:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    result["compared"] = numbers["compared"]
    result["checks"] = check.report(numbers)
    for k, v in check.report(numbers).items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0
