"""Backlog merging in the port's encode queue (``DeviceEncodeDispatcher``):
the groups queued behind the submit thread that share the head's merge
key run as one device group, and each lane's PNG is the bytes its own
group would have produced. The only in-flight slot is held while the
groups are submitted, so the submit thread waits on the first of them
and the rest form a backlog behind it, deterministically. No JAX import.
Inputs: ``numpy.random.default_rng(29)``."""

import concurrent.futures
import json

import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu_torch.models import device_dispatch as dd
from omero_ms_pixel_buffer_tpu_torch.obs import recorder as prec
from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
from omero_ms_pixel_buffer_tpu_torch.resilience import faultinject as pfi
from omero_ms_pixel_buffer_tpu_torch.resilience.faultinject import INJECTOR

rng = np.random.default_rng(29)
ROWS, COLS = 20, 36  # real tile size; lanes are bucket-padded to 24 x 40
BH, BW = 24, 40


def _tiles(n, dtype=np.uint16, rows=ROWS, cols=COLS):
    """``n`` bucket-padded lanes: a smooth ramp with noise, so that
    ``dynamic`` lanes plan codes of their own."""
    hi = 4096 if dtype == np.uint16 else 256
    t = np.zeros((n, BH, BW), dtype)
    ramp = (np.arange(cols)[None, :] * 7 + np.arange(rows)[:, None] * 3) % hi
    for k in range(n):
        noise = rng.integers(0, 2 + 8 * k, (rows, cols))
        t[k, :rows, :cols] = (ramp + noise) % hi
    return t


def _group(n, mode="dynamic", dtype=np.uint16, rows=ROWS, cols=COLS, filter_mode="up",
           staged=False):
    """The keyword arguments of one ``submit`` of ``n`` lanes numbered
    0..n-1, as every batch numbers its own."""
    size = np.dtype(dtype).itemsize
    return dict(tiles=bits_tensor(_tiles(n, dtype, rows, cols)), rows=rows,
                row_bytes=1 + cols * size, bpp=size, filter_mode=filter_mode,
                deflate_mode=mode, lanes=list(range(n)), sizes=[(cols, rows)] * n,
                bit_depth=8 * size, color_type=0, staged=staged)


def _render_group(q, n=2):
    from omero_ms_pixel_buffer_tpu_torch.render.engine import build_tables
    from omero_ms_pixel_buffer_tpu_torch.render.luts import LutRegistry
    from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec

    tables, luts = build_tables(RenderSpec.from_params({"c": "1|0:4095$FF0000,2$00FF00"}),
                                np.dtype(np.uint16), LutRegistry())
    planes = bits_tensor(rng.integers(0, 4096, (n, 2, ROWS, COLS), dtype=np.uint16))
    return q.submit_render(planes, tables, luts, ROWS, 1 + 3 * COLS, "up", "rle",
                           list(range(n)), [(COLS, ROWS)] * n)


class _Held:
    """A queue whose only in-flight slot is held until ``release``: the
    submit thread waits on the first group submitted, the others queue
    behind it. Futures resolve in device-group order (one readback
    thread), which ``order`` records."""

    def __init__(self, device="cpu", **kw):
        self.q = dd.DeviceEncodeDispatcher(torch.device(device), queue_depth=1, **kw)
        self.q._slots.acquire()
        self.futs, self.order = [], []

    def add(self, fut):
        name = len(self.futs)
        fut.add_done_callback(lambda _: self.order.append(name))
        self.futs.append(fut)
        return fut

    def submit(self, **group):
        return self.add(self.q.submit(**group))

    def release(self, timeout=120):
        self.q._slots.release()
        concurrent.futures.wait(self.futs, timeout=timeout)
        assert all(f.done() for f in self.futs)
        return self.q.snapshot()


def _accounted(snap):
    """Every submitted group is completed (as a device group), merged into
    another's, or failed."""
    assert snap["groups"] == snap["completed"] + snap["merged"] + snap["failed"], snap
    assert snap["inflight"] == 0


def _alone(groups, device="cpu"):
    """Each group through its own queue, one at a time."""
    q = dd.DeviceEncodeDispatcher(torch.device(device))
    try:
        return [q.submit(**g).result(120) for g in groups]
    finally:
        q.close()


def _merged_counter() -> float:
    return dd.DEVICE_ENCODE_GROUPS_MERGED.samples().get((), 0.0)


def _merge_cases():
    """(mode, staged, device) for every deflate mode on both routes: on
    the CPU (the kernels' plain versions), and ``cuda``-marked on the card
    (the hand-written filter and packer kernels, the side-stream join)."""
    cases = []
    for device, marks, suffix in (("cpu", (), ""), ("cuda", (pytest.mark.cuda,), "-cuda")):
        for staged, route in ((False, "host"), (True, "staged")):
            for mode in ("dynamic", "rle", "stored"):
                cases.append(pytest.param(mode, staged, device, marks=marks,
                                          id=f"{mode}-{route}{suffix}"))
    return cases


@pytest.mark.parametrize("mode,staged,device", _merge_cases())
def test_merged_streams_match_one_group_at_a_time(mode, staged, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    groups = [_group(n, mode, staged=staged) for n in (3, 1, 4, 2)]
    if staged and device == "cuda":  # staged lanes are device tensors
        for g in groups:
            g["tiles"] = g["tiles"].to(device)
        torch.cuda.synchronize()
    counter0 = _merged_counter()
    held = _Held(device)
    try:
        for g in groups:
            held.submit(**g)
        snap = held.release()
    finally:
        held.q.close()
    merged = [f.result() for f in held.futs]
    # one device group of 10 lanes (padded to 16) in place of four
    assert (snap["completed"], snap["merged"], snap["failed"]) == (1, 3, 0)
    assert snap["lanes"] == 10 and snap["groups"] == 4
    assert _merged_counter() - counter0 == 3
    _accounted(snap)
    for got, want, g in zip(merged, _alone(groups, device), groups):
        assert sorted(got) == g["lanes"]
        assert got == want
    # the members' lanes are distinct tiles: no member got another's
    assert len({png for got in merged for png in got.values()}) == 10


def test_host_and_staged_groups_stay_apart():
    held = _Held()
    try:
        for staged in (False, True, False, True):
            held.submit(**_group(2, "rle", staged=staged))
        snap = held.release()
    finally:
        held.q.close()
    assert (snap["completed"], snap["merged"]) == (4, 0)
    assert held.order == [0, 1, 2, 3]
    _accounted(snap)


def test_incompatible_groups_never_merge_and_keep_fifo():
    held = _Held()
    try:
        base = _group(2)
        held.submit(**base)                               # 0 head
        held.submit(**_group(3))                          # 1 joins 0
        held.submit(**_group(2, rows=ROWS - 4))           # 2 other rows
        held.submit(**_group(1))                          # 3 behind 2: alone
        held.submit(**_group(2, filter_mode="sub"))       # 4 other filter
        held.submit(**_group(2, mode="rle"))              # 5 other mode
        held.submit(**_group(2, dtype=np.uint8))          # 6 other dtype
        held.add(_render_group(held.q))                   # 7 render: never merges
        held.add(_render_group(held.q))                   # 8 render
        held.submit(**_group(1))                          # 9 head
        held.submit(**_group(2))                          # 10 joins 9
        snap = held.release()
    finally:
        held.q.close()
    assert held.order == list(range(11))
    assert (snap["completed"], snap["merged"], snap["failed"]) == (9, 2, 0)
    assert snap["render_groups"] == 2
    _accounted(snap)
    assert sorted(held.futs[1].result()) == [0, 1, 2]
    assert sorted(held.futs[10].result()) == [0, 1]


@pytest.mark.parametrize("sizes,device_groups", [
    ((10, 10, 10, 10, 10), (30, 20)),   # the next group would pass 32
    ((31, 1, 1), (32, 1)),              # up to 32 exactly
    ((32, 1, 1), (32, 2)),              # a full head runs alone
    ((40, 1, 1), (40, 2)),              # so does a larger one
])
def test_merge_stops_at_32_lanes(sizes, device_groups, monkeypatch):
    staged = []
    stage = dd.DeviceEncodeDispatcher._stage_group

    def counting(self, tiles, *args):
        staged.append(tiles.shape[0])
        return stage(self, tiles, *args)

    monkeypatch.setattr(dd.DeviceEncodeDispatcher, "_stage_group", counting)
    held = _Held()
    try:
        for n in sizes:
            held.submit(**_group(n, "stored"))
        snap = held.release()
    finally:
        held.q.close()
    assert tuple(staged) == device_groups
    assert snap["completed"] == len(device_groups)
    assert snap["merged"] == len(sizes) - len(device_groups)
    assert snap["lanes"] == sum(sizes)
    _accounted(snap)


def test_merge_stops_at_the_queues_merge_lanes(monkeypatch):
    staged = []
    stage = dd.DeviceEncodeDispatcher._stage_group

    def counting(self, tiles, *args):
        staged.append(tiles.shape[0])
        return stage(self, tiles, *args)

    monkeypatch.setattr(dd.DeviceEncodeDispatcher, "_stage_group", counting)
    held = _Held(merge_lanes=8)  # a batcher of max batch 8
    try:
        for n in (3, 3, 3, 1, 8, 1):
            held.submit(**_group(n, "stored"))
        snap = held.release()
    finally:
        held.q.close()
    assert tuple(staged) == (6, 4, 8, 1)
    assert (snap["completed"], snap["merged"], snap["lanes"]) == (4, 2, 19)
    _accounted(snap)


def test_a_failed_device_group_fails_every_member():
    held = _Held()
    try:
        for n in (2, 1, 3):
            held.submit(**_group(n, mode="bogus"))  # the chain refuses the mode
        snap = held.release()
    finally:
        held.q.close()
    for fut in held.futs:
        with pytest.raises(ValueError):
            fut.result()
    assert (snap["completed"], snap["merged"], snap["failed"]) == (0, 0, 3)
    assert snap["groups"] == 3
    _accounted(snap)


def test_fault_point_fires_once_per_group_before_it_joins():
    # the head's call passes, the second group's fails: it fails alone and
    # the third still joins the head
    INJECTOR.install("device.encode-group",
                     lambda n: pfi.Fail(KeyError) if n == 1 else None)
    held = _Held()
    try:
        for n in (2, 1, 3):
            held.submit(**_group(n, "rle"))
        snap = held.release()
        calls = INJECTOR.calls("device.encode-group")
    finally:
        INJECTOR.clear()
        held.q.close()
    assert calls == 3
    with pytest.raises(KeyError):
        held.futs[1].result()
    assert sorted(held.futs[0].result()) == [0, 1]
    assert sorted(held.futs[2].result()) == [0, 1, 2]
    assert (snap["completed"], snap["merged"], snap["failed"]) == (1, 1, 1)
    _accounted(snap)


def test_a_lone_group_runs_unmerged():
    q = dd.DeviceEncodeDispatcher(torch.device("cpu"), queue_depth=1)
    try:
        # each submitted after the last resolved: the backlog is empty at
        # every pick-up
        outs = [q.submit(**g).result(120) for g in (_group(2), _group(3), _group(1))]
        snap = q.snapshot()
    finally:
        q.close()
    assert [sorted(o) for o in outs] == [[0, 1], [0, 1, 2], [0]]
    assert (snap["groups"], snap["completed"], snap["merged"]) == (3, 3, 0)
    assert snap["stage_groups"]["submit_wait"] == 3
    _accounted(snap)


def test_mesh_groups_never_merge():
    from omero_ms_pixel_buffer_tpu_torch.parallel.mesh import MeshManager, make_mesh

    held = _Held()
    try:
        held.q.set_mesh_manager(MeshManager(make_mesh(["cpu"] * 2)))
        groups = [_group(n, "rle") for n in (2, 1)]
        for g in groups:
            held.submit(**g)
        snap = held.release()
    finally:
        held.q.close()
    assert (snap["completed"], snap["merged"]) == (2, 0)
    assert [f.result() for f in held.futs] == _alone(groups)
    _accounted(snap)


def test_merge_enters_its_profiler_range(tmp_path):
    from torch._C._profiler import _ExperimentalConfig

    rec = prec.FlightRecord("/tile")
    held = _Held()
    try:
        # the merge is entered on the submit thread
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU],
                experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            with prec.record_scope(rec):
                for n in (1, 2):
                    held.submit(**_group(n, "rle"))
            snap = held.release()
    finally:
        held.q.close()
    assert snap["merged"] == 1
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert f"ompb.queue.merge@{rec.trace_id}" in names
