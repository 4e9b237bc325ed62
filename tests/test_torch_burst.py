"""The port's burst plane (``render/supertile.py`` ``BurstHint``, grid
clustering and the grid-aligned budget split; ``dispatch/batcher.py``
burst continuation) against the JAX package, on the CPU.

- ``assign_supertiles`` on seeded random lane sets on a tile grid, with
  one shared ``BurstHint``, without one, with two different hints, with
  off-grid lanes under a hint, degraded and full-resolution lanes mixed,
  under tight pixel budgets (whole-row and in-row cuts): the same
  partition and return value as the JAX package's.
- ``_burst_extension`` on seeded batches (burst keys, deadlines under a
  scripted clock, the carried burst of the last dispatch and its age on a
  scripted loop clock): the same decisions and extensions as the JAX
  batcher's; the carry set by a dispatch is the same key.
- Through the port's front, a DZI level row requested in two waves
  extends a coalesce window (``/healthz`` ``batcher.burst_continuations``)
  and fuses into super-tiles, with the bytes of the same tiles served
  unfused.

Tolerance: zero."""

import asyncio
import types

import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu.dispatch.batcher import BatchingTileWorker as JaxWorker
from omero_ms_pixel_buffer_tpu.render import supertile as jst
from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxRender
from omero_ms_pixel_buffer_tpu.resilience.deadline import Deadline as JaxDeadline
from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx
from omero_ms_pixel_buffer_tpu_torch.dispatch.batcher import BatchingTileWorker
from omero_ms_pixel_buffer_tpu_torch.render import supertile as pst
from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
from omero_ms_pixel_buffer_tpu_torch.resilience.deadline import Deadline
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

from test_torch_protocols import COOKIE, Fronts

SPECS = ({"c": "1|0:4000$FF0000"}, {"c": "1", "m": "g"})


def _pair(x, y, w, h, spec=0, res=None, session="k", degraded=0, hint=None, deadline=None,
          clock=None):
    p = TileCtx(1, 0, 0, 0, RegionDef(x, y, w, h), resolution=res, format="png",
                omero_session_key=session, render=RenderSpec.from_params(SPECS[spec]),
                degraded=degraded)
    j = JaxCtx(1, 0, 0, 0, JaxRegion(x, y, w, h), resolution=res, format="png",
               omero_session_key=session, render=JaxRender.from_params(SPECS[spec]),
               degraded=degraded)
    if hint is not None:
        p.burst, j.burst = pst.BurstHint(*hint), jst.BurstHint(*hint)
    if deadline is not None:
        p.deadline = Deadline.after(deadline, clock=clock)
        j.deadline = JaxDeadline.after(deadline, clock=clock)
    return p, j


def _partition(ctxs):
    groups = {}
    for i, c in enumerate(ctxs):
        if c.supertile is not None:
            groups.setdefault(id(c.supertile), []).append(i)
    return sorted(groups.values())


def _random_lanes(rng, tile=64):
    """Lanes on a ``tile`` grid (edge lanes narrower), some off-grid,
    degraded or of another spec, with one of a few hint layouts."""
    mode = rng.choice(["hint", "none", "two_hints", "offgrid"])
    lanes = []
    cells = rng.permutation(64)[: int(rng.integers(1, 40))]
    for cell in cells:
        cy, cx = divmod(int(cell), 8)
        w = tile if rng.random() < 0.85 else int(rng.integers(1, tile + 1))
        h = tile if rng.random() < 0.85 else int(rng.integers(1, tile + 1))
        x, y = cx * tile, cy * tile
        if mode == "offgrid" and rng.random() < 0.2:
            x += int(rng.integers(1, tile))
        hint = {"hint": (tile, tile), "none": None, "offgrid": (tile, tile),
                "two_hints": (tile, tile) if rng.random() < 0.5 else (tile, 2 * tile)}[mode]
        lanes.append(dict(x=x, y=y, w=w, h=h, hint=hint,
                          spec=int(rng.random() < 0.1), degraded=int(rng.random() < 0.15)))
    return lanes


@pytest.mark.parametrize("seed", range(6))
def test_assign_supertiles_with_hints_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        lanes = _random_lanes(rng)
        kwargs = dict(max_pixels=int(rng.choice([4 << 20, 64 * 64 * 3, 64 * 64 * 8,
                                                 64 * 64 * 17])),
                      min_lanes=int(rng.choice([2, 3])),
                      min_coverage=float(rng.choice([0.5, 0.8])))
        pairs = [_pair(**ln) for ln in lanes]
        port, jax = [p for p, _ in pairs], [j for _, j in pairs]
        assert pst.assign_supertiles(port, **kwargs) == jst.assign_supertiles(jax, **kwargs)
        assert _partition(port) == _partition(jax)
        for c in port:
            if c.supertile is not None:
                assert c.supertile.n == sum(d.supertile is c.supertile for d in port)


def test_grid_rows_split_at_whole_rows():
    """A 4x3 hinted grid over a five-tile budget: whole rows, never a cut
    inside a row that fits; a row wider than the budget splits at
    columns. The hintless split of the same lanes cuts greedily."""
    lanes = [dict(x=64 * c, y=64 * r, w=64, h=64, hint=(64, 64))
             for r in range(3) for c in range(4)]
    for hint in ((64, 64), None):
        pairs = [_pair(**{**ln, "hint": hint}) for ln in lanes]
        port, jax = [p for p, _ in pairs], [j for _, j in pairs]
        assert pst.assign_supertiles(port, max_pixels=5 * 64 * 64) == \
            jst.assign_supertiles(jax, max_pixels=5 * 64 * 64)
        assert _partition(port) == _partition(jax)
        if hint is not None:
            assert _partition(port) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    wide = [_pair(64 * c, 0, 64, 64, hint=(64, 64)) for c in range(8)]
    assert pst.assign_supertiles([p for p, _ in wide], max_pixels=3 * 64 * 64) == \
        jst.assign_supertiles([j for _, j in wide], max_pixels=3 * 64 * 64)
    assert _partition([p for p, _ in wide]) == _partition([j for _, j in wide])


class _Loop:
    """A scripted loop clock (``time()``)."""

    def __init__(self, t=50.0):
        self.t = t

    def time(self):
        return self.t


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _workers():
    """The port's batcher and the JAX one at the JAX defaults (32 lanes,
    a 25 ms burst window)."""
    port = BatchingTileWorker(object())
    jax = JaxWorker(object(), None,
                    burst_continuation=types.SimpleNamespace(enabled=True, window_ms=25.0))
    return port, jax


@pytest.mark.parametrize("seed", range(4))
def test_burst_extension_matches_jax(seed):
    rng = np.random.default_rng(seed)
    port, jax = _workers()
    loop, clock = _Loop(), _Clock()
    try:
        for _ in range(400):
            n = int(rng.choice([1, 2, 3, 5, 9, 31, 32]))
            batch_p, batch_j = [], []
            for _ in range(n):
                kind = rng.random()
                ln = dict(x=int(rng.integers(0, 4)) * 256, y=0, w=256, h=256,
                          spec=int(rng.random() < 0.3),
                          session=f"s{int(rng.integers(0, 2))}",
                          hint=(256, 256) if kind < 0.8 else None,
                          deadline=None if rng.random() < 0.3 else float(rng.uniform(0, 0.2)),
                          clock=clock)
                p, j = _pair(**ln)
                if kind > 0.95:
                    p.render = j.render = None  # a /tile lane: no burst key
                batch_p.append((p, None))
                batch_j.append((j, None))
            if rng.random() < 0.5:  # the last dispatch's burst, carried
                key_p = port._burst_key(batch_p[0][0])
                key_j = jax._burst_key(batch_j[0][0])
                assert key_p == key_j
                age = float(rng.choice([0.0, 0.01, 0.025, 0.03]))
                port._last_burst = None if key_p is None else (key_p, loop.t - age)
                jax._last_burst = None if key_j is None else (key_j, loop.t - age)
            else:
                port._last_burst = jax._last_burst = None
            assert port._burst_extension(batch_p, loop) == jax._burst_extension(batch_j, loop)
            loop.t += 1.0
    finally:
        port._executor.shutdown()
        jax._executor.shutdown()


async def test_dispatch_carries_the_dominant_burst_like_jax():
    """``_coalesce_and_dispatch`` (the base window and the extension wait
    on an empty queue) records the same dominant burst key in both."""
    port, jax = _workers()
    launched = []

    async def execute(batch, loop):
        launched.append(len(batch))

    port._execute = jax._execute = execute
    loop = asyncio.get_running_loop()
    try:
        lanes = [dict(x=256 * i, y=0, w=256, h=256, hint=(256, 256)) for i in range(3)]
        lanes += [dict(x=0, y=256, w=256, h=256, spec=1, hint=(256, 256))]
        pairs = [_pair(**ln) for ln in lanes]
        for worker, side in ((port, 0), (jax, 1)):
            sem = asyncio.Semaphore(2)
            await worker._coalesce_and_dispatch([(pr[side], loop.create_future())
                                                 for pr in pairs], loop, sem)
        await asyncio.sleep(0)
        assert port._last_burst[0] == jax._last_burst[0]
        assert port._last_burst[0][5] == pairs[0][0].render.signature()
        assert launched == [4, 4] and port.burst_continuations == 1
    finally:
        port._executor.shutdown()
        jax._executor.shutdown()


async def test_dzi_burst_continues_and_fuses(tmp_path):
    """Two waves of a DZI level row through the port's front: the second
    window extends (``burst_continuations``), lanes are stamped and fused,
    and every tile equals the JAX app's and its unfused bytes."""
    from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff

    from test_torch_protocols import IMG

    path = str(tmp_path / "img.ome.tiff")
    write_ome_tiff(path, IMG, tile_size=(128, 128), pyramid_levels=3)
    f = await Fronts().start(path)
    try:
        urls = [f"/dzi/1_files/10/{c}_{r}.png" for r in range(3) for c in range(3)]
        first = await asyncio.gather(*(f.port_request("GET", u, COOKIE) for u in urls[:5]))
        await asyncio.sleep(0.005)
        second = await asyncio.gather(*(f.port_request("GET", u, COOKIE) for u in urls[5:]))
        view = f.port.health()
        assert view["batcher"]["burst_continuations"] >= 1
        assert view["supertile"]["stamped_lanes"] >= 2
        for url, (status, _, body) in zip(urls, first + second):
            js, _, jb = await f.jax_request("GET", url, COOKIE)
            assert (status, body) == (js, jb) == (200, jb), url
    finally:
        await f.close()
