"""The port's degraded reads (the scheduler's hybrid-resolution fallback,
``models/tile_pipeline.py``) against the JAX package, on the CPU.

- ``_degrade_plan_rect`` over random level sizes (odd, non-power-of-two,
  floor and ceil halvings, factor-3 levels) and rectangles: the same
  coarse region and index maps.
- ``handle_batch`` on batches that mix degraded and full-resolution
  lanes: ``/tile`` PNG, raw and TIFF lanes, ``/render`` lanes (plain,
  projected, greyscale), histogram lanes (read at full resolution, as in
  JAX) and stamped super-tiles of degraded lanes, from an OME-TIFF and a
  Zarr pyramid: the same results as JAX ``handle_batch``, and the same
  ``degraded`` flags after (cleared where no coarser level exists).
- A degraded raw lane is the level-1 region with its rows and columns
  replicated (an independent spelling of the plan); a degraded lane on a
  plane resident in the plane cache still reads the coarse level.
- ``cuda``: the same batch on the card equals its CPU run.

Tolerance: zero (bytes, statuses, flags)."""

import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu_torch.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.io.zarr import write_ngff
from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import TilePipeline
from omero_ms_pixel_buffer_tpu_torch.render import supertile as pst
from omero_ms_pixel_buffer_tpu_torch.render.analysis import HistogramSpec
from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

# T, C, Z, Y, X: 260x300, levels 130x150 and 65x75
DATA = np.random.default_rng(23).integers(0, 4096, (1, 3, 2, 260, 300), dtype=np.uint16)
BUCKETS = (64, 128)
C_QUERY = "1|0:3000$FF0000,2|0:4000$00FF00,3$0000FF"


class _Levels:
    def __init__(self, sizes):
        self.sizes = sizes

    def level_size(self, level):
        return self.sizes[level]


def test_degrade_plan_rect_matches_jax():
    from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline as JaxPipeline

    rng = np.random.default_rng(5)
    for _ in range(600):
        w0, h0 = (int(v) for v in rng.integers(1, 3000, 2))
        sizes = [(w0, h0)]
        for _ in range(3):
            w, h = sizes[-1]
            div = int(rng.choice([2, 2, 3]))
            up = int(rng.integers(0, 2))
            sizes.append((max(1, (w + up * (div - 1)) // div), max(1, (h + up * (div - 1)) // div)))
        buf = _Levels(sizes)
        level = int(rng.integers(0, 3))
        dlevel = int(rng.integers(level + 1, 4))
        sx, sy = sizes[level]
        x, y = int(rng.integers(0, sx)), int(rng.integers(0, sy))
        w, h = int(rng.integers(1, sx - x + 1)), int(rng.integers(1, sy - y + 1))
        got = TilePipeline._degrade_plan_rect(buf, level, dlevel, x, y, w, h)
        want = JaxPipeline._degrade_plan_rect(buf, level, dlevel, x, y, w, h)
        assert got[:4] == want[:4]
        assert np.array_equal(got[4], want[4]) and np.array_equal(got[5], want[5])


@pytest.fixture(scope="module", params=["ometiff", "zarr"])
def source(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("degrade")
    if request.param == "ometiff":
        path = str(root / "img.ome.tiff")
        write_ome_tiff(path, DATA, tile_size=(64, 64), pyramid_levels=3, compression="zlib")
        return path, {}
    path = str(root / "img.zarr")
    write_ngff(path, DATA, chunks=(64, 64), levels=3, compressor="zlib")
    return path, {"type": "zarr"}


def _pipelines(source, device="cpu"):
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JR
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JS
    from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline as JP

    path, extra = source
    jreg, reg = JR(), ImageRegistry()
    jreg.add(1, path, **extra)
    reg.add(1, path, **extra)
    jp = JP(JS(jreg), engine="device", device_deflate=True, buckets=BUCKETS)
    jp.mesh = None
    return jp, TilePipeline(PixelsService(reg, device=device), buckets=BUCKETS, device=device)


def _ctx_pair(x, y, w, h, z=0, c=0, res=None, fmt="png", degraded=1, render=None,
              hist=None):
    """The same lane as a port and a JAX ``TileCtx``."""
    from omero_ms_pixel_buffer_tpu.render.analysis import HistogramSpec as JaxHist
    from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxRender
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
    from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx

    p = TileCtx(1, z, c, 0, RegionDef(x, y, w, h), resolution=res, format=fmt,
                omero_session_key="k", degraded=degraded)
    j = JaxCtx(1, z, c, 0, JaxRegion(x, y, w, h), resolution=res, format=fmt,
               omero_session_key="k", degraded=degraded)
    if render is not None:
        p.render, j.render = RenderSpec.from_params(render), JaxRender.from_params(render)
        p.format = j.format = p.render.format
    if hist is not None:
        p.analysis, j.analysis = HistogramSpec.from_params(hist), JaxHist.from_params(hist)
        p.format = j.format = "json"
    return p, j


LANES = {
    "tile": [
        dict(x=0, y=0, w=64, h=64), dict(x=37, y=11, w=101, h=57),
        dict(x=236, y=196, w=64, h=64), dict(x=0, y=0, w=300, h=260),
        dict(x=5, y=3, w=33, h=17, res=1), dict(x=0, y=0, w=75, h=65, res=2),
        dict(x=10, y=10, w=64, h=64, degraded=0), dict(x=10, y=10, w=20, h=20, fmt=None),
        dict(x=3, y=4, w=50, h=40, fmt="tif"), dict(x=250, y=0, w=100, h=10),
        dict(x=0, y=0, w=64, h=64, z=1, c=2),
    ],
    "render": [
        dict(x=0, y=0, w=64, h=64, render={"c": C_QUERY}),
        dict(x=100, y=30, w=77, h=50, render={"c": C_QUERY, "p": "intmax|0:1"}),
        dict(x=0, y=0, w=64, h=64, render={"c": "2|0:3000", "m": "g"}),
        dict(x=0, y=0, w=40, h=40, res=2, render={"c": C_QUERY}),
        dict(x=64, y=0, w=64, h=64, render={"c": C_QUERY}, degraded=0),
        dict(x=0, y=0, w=64, h=64, render={"c": C_QUERY, "format": "jpeg"}),
    ],
    "histogram": [
        dict(x=0, y=0, w=64, h=64, hist={"c": "1,2", "bins": "64"}),
        dict(x=11, y=7, w=90, h=33, hist={"bins": "256"}, degraded=0),
    ],
}


@pytest.mark.parametrize("kind", list(LANES))
def test_degraded_lanes_match_jax(source, kind):
    """Two rounds (cold, then planes admitted): the same results and
    final ``degraded`` flags as JAX ``handle_batch``."""
    jp, pp = _pipelines(source)
    try:
        for rnd in range(2):
            pairs = [_ctx_pair(**ln) for ln in LANES[kind]]
            got = pp.handle_batch([p for p, _ in pairs])
            want = jp.handle_batch([j for _, j in pairs])
            assert got == want, rnd
            assert [p.degraded for p, _ in pairs] == [j.degraded for _, j in pairs]
            assert sum(r is not None for r in got) >= len(got) - 1
        if kind == "tile":
            # no level below the last: served at full resolution, untagged
            assert [p.degraded for p, _ in pairs][5] == 0
    finally:
        jp.close()
        pp.close()


def _expected_degraded(level_data, x, y, w, h, sizes, level=0):
    """The plan's contract spelled independently: pixel (Y, X) of the
    requested level reads coarse pixel (Y * sy1 // sy0, X * sx1 // sx0)."""
    (sx0, sy0), (sx1, sy1) = sizes[level], sizes[level + 1]
    ys = np.minimum((y + np.arange(h)) * sy1 // sy0, sy1 - 1)
    xs = np.minimum((x + np.arange(w)) * sx1 // sx0, sx1 - 1)
    return level_data[np.ix_(ys, xs)]


def test_degraded_raw_lane_is_the_coarse_region_replicated(source):
    jp, pp = _pipelines(source)
    try:
        buf = pp.pixels_service.get_pixel_buffer(1)
        sizes = [buf.level_size(r) for r in range(buf.resolution_levels)]
        coarse = buf.get_tile_at(1, 1, 2, 0, 0, 0, *sizes[1])
        for x, y, w, h in ((0, 0, 64, 64), (37, 11, 101, 57), (299, 259, 1, 1)):
            p, _ = _ctx_pair(x, y, w, h, z=1, c=2, fmt=None)
            got = pp.handle_batch([p, _ctx_pair(0, 0, 8, 8, fmt=None)[0]])[0]
            want = _expected_degraded(coarse, x, y, w, h, sizes)
            assert got == want.astype(">u2").tobytes()
    finally:
        jp.close()
        pp.close()


def test_degraded_lane_never_crops_a_resident_plane(source):
    """Full-resolution PNG lanes admit the level-0 plane to the plane
    cache (second touch); a degraded lane of that plane then still reads
    the coarse level (JAX's bytes, not the full-resolution tile's)."""
    jp, pp = _pipelines(source)
    try:
        for _ in range(3):
            full = [_ctx_pair(x, 0, 64, 64, degraded=0)[0] for x in (0, 64)]
            pp.handle_batch(full)
        assert pp.plane_cache.snapshot()["hits"] > 0
        pairs = [_ctx_pair(x, 0, 64, 64) for x in (0, 64)]
        got = pp.handle_batch([p for p, _ in pairs])
        assert got == jp.handle_batch([j for _, j in pairs])
        full = pp.handle_batch([_ctx_pair(x, 0, 64, 64, degraded=0)[0] for x in (0, 64)])
        assert got[0] != full[0]
    finally:
        jp.close()
        pp.close()


def _pan(degraded, z=0, res=None):
    lanes = []
    for y, h in ((0, 64), (64, 64), (128, 64), (192, 68)):
        for x, w in ((0, 64), (64, 64), (128, 64), (192, 64), (256, 44)):
            lanes.append(dict(x=x, y=y, w=w, h=h, z=z, res=res, degraded=degraded,
                              render={"c": C_QUERY}))
    return lanes


@pytest.mark.parametrize("mix", ["degraded", "mixed", "level1"])
def test_degraded_supertiles_match_jax(source, mix):
    """Stamped pans: degraded lanes fuse with degraded lanes only (the
    flag is in the fuse key), one coarse gather and upscale per group, with
    JAX's bytes and the unfused lanes' bytes."""
    from omero_ms_pixel_buffer_tpu.render.supertile import assign_supertiles as jax_assign

    lanes = {"degraded": _pan(1), "mixed": _pan(1)[:10] + _pan(0)[10:],
             "level1": [ln for ln in _pan(1, res=1) if ln["x"] < 150 and ln["y"] < 130]}[mix]
    for ln in lanes:  # clip to the requested level
        limit_w, limit_h = (300, 260) if ln["res"] is None else (150, 130)
        ln["w"], ln["h"] = min(ln["w"], limit_w - ln["x"]), min(ln["h"], limit_h - ln["y"])
    jp, pp = _pipelines(source)
    _, plain = _pipelines(source)
    try:
        pairs = [_ctx_pair(**ln) for ln in lanes]
        port_ctxs, jax_ctxs = [p for p, _ in pairs], [j for _, j in pairs]
        assert pst.assign_supertiles(port_ctxs) == jax_assign(jax_ctxs)
        groups = {id(c.supertile) for c in port_ctxs if c.supertile is not None}
        assert len(groups) == (2 if mix == "mixed" else 1)
        got = pp.handle_batch(port_ctxs)
        assert got == jp.handle_batch(jax_ctxs)
        assert got == plain.handle_batch([_ctx_pair(**ln)[0] for ln in lanes])
        snap = pp.supertile_snapshot()
        assert snap["device_lanes"] == len(lanes) and snap["fallback_lanes"] == 0
    finally:
        jp.close()
        pp.close()
        plain.close()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_degraded_lanes_match_cpu(cuda_device, tmp_path):
    """Degraded /tile, /render and super-tile lanes on the card (filter and
    SP-packer kernels) against the port's CPU run."""
    path = str(tmp_path / "img.ome.tiff")
    write_ome_tiff(path, DATA, tile_size=(64, 64), pyramid_levels=3, compression="zlib")
    reg = ImageRegistry()
    reg.add(1, path)
    lanes = [dict(ln) for ln in LANES["tile"] + LANES["render"] + _pan(1)]
    for ln in lanes:
        ln.setdefault("res", None)
        ln["w"], ln["h"] = min(ln["w"], 300 - ln["x"]), min(ln["h"], 260 - ln["y"])
    out = []
    for device in ("cpu", cuda_device):
        pipe = TilePipeline(PixelsService(reg, device=device), buckets=BUCKETS, device=device)
        try:
            ctxs = [_ctx_pair(**ln)[0] for ln in lanes]
            pst.assign_supertiles(ctxs)
            out.append(pipe.handle_batch(ctxs))
        finally:
            pipe.close()
    assert out[0] == out[1]
