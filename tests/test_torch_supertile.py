"""The port's super-tile fusion (``render/supertile.py``, the batcher's
stamping and ``TilePipeline._supertile_group``) against the JAX package,
on the CPU.

- ``assign_supertiles`` stamps the same partition of lanes as the JAX
  package's: grid bursts, non-adjacent lanes, the pixel budget,
  ``min_lanes``, the coverage bound, masked, analysis, full-plane and
  expired lanes (never stamped), off-grid, overlapping and mixed-size
  lanes.
- ``composite_carve_torch`` (the CPU run of the device program) equals
  JAX ``composite_carve_batch`` over whole carved buckets, edge lanes
  included.
- ``handle_batch`` on a stamped 4x4 pan (u16 and i16; plain, projected
  and greyscale specs; mixed edge sizes; a lane that 404s inside the
  group; a JPEG burst and ``device_deflate=False`` on the host carve)
  equals JAX ``handle_batch`` on the same stamps and the port's own
  unfused lanes, over three rounds (cold, planes admitted, resident).
- Two super-tiles of one batch share one encode group per lane size.
- Through the batcher, a coalesced pan is stamped and counted on
  ``/healthz``; with fusion off nothing is stamped.
- A failed fused group answers 500.
- ``cuda``: the composite + carve on the card equals its CPU run.

JAX is imported inside the tests that use it, so the ``cuda`` case also
runs where only PyTorch is installed (``python -m pytest
tests/test_torch_supertile.py -m cuda --noconftest``). Tolerance: zero
(stamps, pixels, statuses and bytes)."""

import asyncio
import time

import numpy as np
import pytest
import torch

import omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline as port_tp
from omero_ms_pixel_buffer_tpu_torch.dispatch.batcher import BatchingTileWorker
from omero_ms_pixel_buffer_tpu_torch.errors import InternalError
from omero_ms_pixel_buffer_tpu_torch.http.server import TileServer
from omero_ms_pixel_buffer_tpu_torch.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
from omero_ms_pixel_buffer_tpu_torch.render import engine as pe
from omero_ms_pixel_buffer_tpu_torch.render import supertile as pst
from omero_ms_pixel_buffer_tpu_torch.render.analysis import HistogramSpec
from omero_ms_pixel_buffer_tpu_torch.render.luts import LutRegistry
from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

SHAPE = (1, 3, 4, 200, 260)  # T, C, Z, Y, X
BUCKETS = (64, 128)
C_QUERY = "1|0:3000$FF0000,2|0:4000$00FF00,3$0000FF"


# -- the bucketing ------------------------------------------------------------------


def _lane(x, y, w=32, h=32, z=1, query=None, hist=False, expired=False):
    return dict(x=x, y=y, w=w, h=h, z=z, query=query or {"c": "1|0:4095$FF0000,2$00FF00"},
                hist=hist, expired=expired)


def _grid(cols, rows, tile=32, **kw):
    return [_lane(tile * c, tile * r, tile, tile, **kw) for r in range(rows) for c in range(cols)]


def _both_ctxs(lanes):
    """Port and JAX contexts of the same lanes."""
    from omero_ms_pixel_buffer_tpu.render.analysis import HistogramSpec as JaxHist
    from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxRender
    from omero_ms_pixel_buffer_tpu.resilience.deadline import Deadline
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
    from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx

    port, jax = [], []
    for ln in lanes:
        ps, js = RenderSpec.from_params(ln["query"]), JaxRender.from_params(ln["query"])
        region = (ln["x"], ln["y"], ln["w"], ln["h"])
        p = TileCtx(1, ln["z"], 0, 0, RegionDef(*region), format=ps.format,
                    omero_session_key="k", render=ps)
        j = JaxCtx(1, ln["z"], 0, 0, JaxRegion(*region), format=js.format,
                   omero_session_key="k", render=js)
        if ln["hist"]:
            p.analysis, j.analysis = HistogramSpec.from_params({}), JaxHist.from_params({})
        if ln["expired"]:
            p.deadline, j.deadline = time.monotonic() - 1.0, Deadline.after(0)
        port.append(p)
        jax.append(j)
    return port, jax


def _partition(ctxs):
    groups = {}
    for i, c in enumerate(ctxs):
        if c.supertile is not None:
            groups.setdefault(id(c.supertile), []).append(i)
            assert c.supertile.n == sum(1 for d in ctxs if d.supertile is c.supertile)
    return sorted(groups.values())


BUCKETING = {
    "grid": (_grid(3, 2), {}),
    "non_adjacent": (_grid(2, 1) + [_lane(96, 64)], {}),
    "budget": (_grid(4, 1), {"max_pixels": 2 * 32 * 32}),
    "budget_rows": (_grid(4, 3), {"max_pixels": 5 * 32 * 32}),
    "min_lanes": (_grid(2, 1) + [_lane(200, 200), _lane(232, 200), _lane(264, 200)],
                  {"min_lanes": 3}),
    "single": ([_lane(0, 0)], {}),
    "coverage_sparse": ([_lane(0, 0), _lane(32, 32)], {"min_coverage": 0.9}),
    "coverage_half": ([_lane(0, 0), _lane(32, 32)], {"min_coverage": 0.5}),
    "masked_analysis_full": (
        _grid(2, 1) + [_lane(0, 32, query={"c": "1", "roi": '[{"type":"rect","x":0,'
                                                          '"y":0,"w":30,"h":20}]'}),
                       _lane(32, 32, query={"c": "1", "roi": '[{"type":"rect","x":0,'
                                                            '"y":0,"w":30,"h":20}]'}),
                       _lane(64, 0, hist=True), _lane(64, 32, hist=True),
                       _lane(0, 64, w=0, h=0), _lane(32, 64, w=0, h=0)], {}),
    "expired": (_grid(2, 1, expired=False)[:1] + [_lane(32, 0, expired=True)], {}),
    "keys": (_grid(2, 1) + [_lane(64, 0, query={"c": "1", "m": "g"}),
                            _lane(96, 0, query={"c": "1", "m": "g"}),
                            _lane(0, 32, z=2), _lane(32, 32, z=2)], {}),
    "over_budget_tile": (_grid(2, 1, tile=64), {"max_pixels": 64 * 64 - 1}),
    "rows": (_grid(3, 2), {"max_pixels": 3 * 32 * 32}),
    "rows_split": (_grid(4, 2), {"max_pixels": 3 * 32 * 32}),
    "off_grid": (_grid(2, 1) + [_lane(70, 3)], {}),
    "islands": (_grid(3, 2) + [_lane(160, 160), _lane(192, 160)], {}),
    # random 16-aligned overlapping tiles, as a viewer's zoom or a random
    # read sends them
    "overlapping": ([_lane(int(x), int(y), 48, 48) for x, y in
                     np.random.default_rng(5).integers(0, 8, (12, 2)) * 16],
                    {"max_pixels": 96 * 96}),
    "mixed_sizes": ([_lane(0, 0, 64, 32), _lane(64, 0, 16, 32), _lane(0, 32, 80, 8)], {}),
}


@pytest.mark.parametrize("case", list(BUCKETING))
def test_assign_supertiles_matches_jax(case):
    from omero_ms_pixel_buffer_tpu.render.supertile import assign_supertiles as jax_assign

    lanes, kwargs = BUCKETING[case]
    port, jax = _both_ctxs(lanes)
    got, want = pst.assign_supertiles(port, **kwargs), jax_assign(jax, **kwargs)
    assert got == want
    assert _partition(port) == _partition(jax)
    # a restamp clears a stale stamp first
    assert pst.assign_supertiles(port, **kwargs) == got and _partition(port) == _partition(jax)


def test_bounding_rect_and_carve_host_match_jax():
    from omero_ms_pixel_buffer_tpu.render import supertile as jst

    rects = [(3, 5, 10, 7), (13, 5, 4, 20), (0, 30, 2, 2)]
    assert pst.bounding_rect(rects) == jst.bounding_rect(rects)
    rgb = np.arange(40 * 30 * 3, dtype=np.uint8).reshape(40, 30, 3)
    assert np.array_equal(pst.carve_host(rgb, 4, 6, 10, 9), jst.carve_host(rgb, 4, 6, 10, 9))


# -- the device program ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("query", [C_QUERY, "2|100:900$fire", "1,2,3&m=g"])
def test_composite_carve_matches_jax(dtype, query):
    """Whole carved (B, 64, 64, 3) buckets of a 150 x 200 super-tile, the
    edge lanes' pad regions included."""
    from omero_ms_pixel_buffer_tpu.render.supertile import composite_carve_batch

    params = dict(p.split("=", 1) for p in ("c=" + query).split("&"))
    spec = RenderSpec.from_params(params)
    tables, luts = pe.build_tables(spec, np.dtype(dtype), LutRegistry())
    info = np.iinfo(dtype)
    planes = np.random.default_rng(3).integers(0, info.max, (3, 150, 200), dtype=dtype,
                                               endpoint=True)
    coords = [(0, 0), (0, 64), (0, 136), (64, 0), (86, 136), (120, 170), (149, 199)]
    want = np.asarray(composite_carve_batch(planes, tables, luts, coords, 64, 64))
    got = pst.composite_carve_torch(bits_tensor(planes), tables, luts, coords, 64, 64)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    packed = torch.from_numpy(pe.packed_rgb_tables(tables, luts))
    again = pst.composite_carve_torch(bits_tensor(planes), tables, luts, coords, 64, 64,
                                      packed=packed)
    assert torch.equal(again, got)


# -- the pipeline ---------------------------------------------------------------------


@pytest.fixture(scope="module", params=["u2", "i2"])
def image(request, tmp_path_factory):
    info = np.iinfo(np.dtype(request.param))
    data = np.random.default_rng(17).integers(max(info.min, -3000), 4096, SHAPE,
                                              dtype=np.dtype(request.param))
    path = str(tmp_path_factory.mktemp("supertile") / f"img_{request.param}.ome.tiff")
    write_ome_tiff(path, data, tile_size=(64, 64), compression="zlib")
    return path, data


def _jax_pipeline(path, device_deflate=True):
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JR
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JS
    from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline as JP

    reg = JR()
    reg.add(1, path)
    pipe = JP(JS(reg), engine="device", buckets=BUCKETS, device_deflate=device_deflate)
    pipe.mesh = None
    return pipe


def _port_pipeline(path, **kwargs):
    reg = ImageRegistry()
    reg.add(1, path)
    return port_tp.TilePipeline(PixelsService(reg), buckets=BUCKETS, device="cpu", **kwargs)


def _pan(query, z=0):
    """A 4 x 4 pan at the image's bottom-right edge: tiles of 64 x 56, the
    last column 32 wide and the last row 32 high (four size classes,
    one bucket), plus one adjacent lane off the plane (it resolves to 404
    inside the group)."""
    lanes = []
    for y, h in ((0, 56), (56, 56), (112, 56), (168, 32)):
        for x, w in ((36, 64), (100, 64), (164, 64), (228, 32)):
            lanes.append(_lane(x, y, w, h, z=z, query=query))
    lanes.append(_lane(228, 0, 64, 56, z=z, query=query))  # x + w > 260
    return lanes


PANS = {
    "composite": {"c": C_QUERY},
    "intmax": {"c": "1|0:4000$FF0000,2$00FF00", "p": "intmax|0:3"},
    "intmean_t": {"c": "3$FF00FF", "p": "intmean:t"},
    "greyscale": {"c": "2|100:3000", "m": "g"},
    "jpeg": {"c": C_QUERY, "format": "jpeg", "q": "0.8"},
}


def _stamp_both(lanes):
    from omero_ms_pixel_buffer_tpu.render.supertile import assign_supertiles as jax_assign

    port, jax = _both_ctxs(lanes)
    assert pst.assign_supertiles(port) == jax_assign(jax) == len(lanes)
    assert _partition(port) == _partition(jax)
    return port, jax


@pytest.mark.parametrize("pan", list(PANS))
def test_stamped_pan_matches_jax_and_unfused(image, pan):
    path, _ = image
    jp, pp, plain = _jax_pipeline(path), _port_pipeline(path), _port_pipeline(path)
    try:
        for rnd in range(3):
            port_ctxs, jax_ctxs = _stamp_both(_pan(PANS[pan]))
            got = pp.handle_batch(port_ctxs)
            assert got == jp.handle_batch(jax_ctxs), rnd
            unfused, _ = _both_ctxs(_pan(PANS[pan]))
            assert got == plain.handle_batch(unfused), rnd
            assert got[-1] is None and all(isinstance(b, bytes) for b in got[:-1])
            assert (pp.render_snapshot()["projection_host_pulls"]
                    == jp.render_snapshot()["projection_host_pulls"]), rnd
        snap = pp.supertile_snapshot()
        assert snap["groups"] == 3 and snap["fallback_lanes"] == 0
        if pan == "jpeg":
            assert snap["host_lanes"] == 48 and snap["device_lanes"] == 0
            assert got[0][:2] == b"\xff\xd8"
        else:
            assert snap["device_lanes"] == 48 and snap["host_lanes"] == 0
            # one encode group per size class and round
            assert snap["encode_groups"] == pp.dispatcher.snapshot()["groups"] == 12
        assert pp.plane_cache.snapshot()["hits"] > 0
    finally:
        jp.close()
        pp.close()
        plain.close()


def test_host_deflate_pan_carves_on_the_host(image):
    """``device_deflate=False``: the group composites once on the host."""
    path, _ = image
    jp, pp = _jax_pipeline(path, device_deflate=False), _port_pipeline(path, device_deflate=False)
    try:
        port_ctxs, jax_ctxs = _stamp_both(_pan(PANS["composite"]))
        assert pp.handle_batch(port_ctxs) == jp.handle_batch(jax_ctxs)
        assert pp.supertile_snapshot()["host_lanes"] == 16
        assert pp.render_snapshot()["host_lanes"] == 16
        assert pp.dispatcher.snapshot()["groups"] == 0
    finally:
        jp.close()
        pp.close()


def test_declined_groups_serve_independently(image):
    """A stale stamp (one live lane left), a channel out of range and a
    bounding rectangle over ``max_tile_bytes`` return their lanes to the
    independent path, counted, with the JAX package's results."""
    path, _ = image
    budget = 50_000  # one 64 x 64 three-channel tile fits, their 192 x 64 rectangle not
    jp, pp = _jax_pipeline(path), _port_pipeline(path, max_tile_bytes=budget)
    jp.max_tile_bytes = budget
    try:
        lanes = ([_lane(0, 0, 64, 64), _lane(64, 0, 64, 64)]
                 + [_lane(0, 100, 32, 32, query={"c": "9"}),
                    _lane(32, 100, 32, 32, query={"c": "9"})]
                 + [_lane(x, 136, 64, 64, z=2, query={"c": C_QUERY}) for x in (0, 64, 128)])
        port_ctxs, jax_ctxs = _stamp_both(lanes)
        # the stamp goes stale: one lane's region leaves the plane after
        # stamping, so it resolves to 404 and its partner is left alone
        port_ctxs[1].region.x = jax_ctxs[1].region.x = 300
        got = pp.handle_batch(port_ctxs)
        assert got == jp.handle_batch(jax_ctxs)
        assert isinstance(got[0], bytes) and got[1] is None
        assert got[2] is None and got[3] is None
        assert all(isinstance(b, bytes) for b in got[4:])
        snap = pp.supertile_snapshot()
        assert snap["groups"] == 0 and snap["fallback_lanes"] == 6
    finally:
        jp.close()
        pp.close()


def test_supertiles_of_a_batch_share_encode_groups(image):
    """Two stamped 2x2 pans of one batch, far apart and on different z,
    composite apart and encode together: one group per lane size (three
    sizes), with JAX's and the unfused lanes' bytes."""
    path, _ = image
    jp, pp, plain = _jax_pipeline(path), _port_pipeline(path), _port_pipeline(path)
    try:
        lanes = ([_lane(x, y, 64, 56, query={"c": C_QUERY}) for y in (0, 56) for x in (0, 64)]
                 + [_lane(x, y, 64, 56, z=3, query={"c": C_QUERY})
                    for y in (112, 168) for x in (164, 228)])
        for ln in lanes:  # clip the second pan to the plane: two more sizes
            ln["w"], ln["h"] = min(ln["w"], 260 - ln["x"]), min(ln["h"], 200 - ln["y"])
        port_ctxs, jax_ctxs = _stamp_both(lanes)
        assert len(_partition(port_ctxs)) == 2
        got = pp.handle_batch(port_ctxs)
        assert got == jp.handle_batch(jax_ctxs)
        unfused, _ = _both_ctxs(lanes)
        assert got == plain.handle_batch(unfused)
        snap = pp.supertile_snapshot()
        assert snap["groups"] == 2 and snap["device_lanes"] == 8
        sizes = {(ln["w"], ln["h"]) for ln in lanes}
        assert len(sizes) == 4
        assert snap["encode_groups"] == pp.dispatcher.snapshot()["groups"] == len(sizes)
    finally:
        jp.close()
        pp.close()
        plain.close()


def test_failed_fused_group_answers_500(image, monkeypatch):
    path, _ = image
    pp = _port_pipeline(path)

    def broken(*args, **kwargs):
        raise RuntimeError("composite down")

    monkeypatch.setattr(port_tp.stile, "composite_carve_torch", broken)
    try:
        port_ctxs, _ = _stamp_both(_pan(PANS["composite"]))
        out = pp.handle_batch(port_ctxs)
        assert all(isinstance(r, InternalError) and r.code == 500 for r in out[:-1])
        assert out[-1] is None
        assert pp.dispatcher.snapshot()["failed"] == 1
    finally:
        pp.close()


# -- through the batcher --------------------------------------------------------------


@pytest.mark.parametrize("enabled", [True, False])
async def test_batcher_stamps_a_coalesced_pan(image, enabled):
    """Sixteen concurrent /render lanes of a pan coalesce into one batch:
    with fusion on they are stamped and served fused (``/healthz``
    ``supertile``), with it off they are not; the bytes are the same."""
    path, _ = image
    pp, plain = _port_pipeline(path), _port_pipeline(path)
    worker = BatchingTileWorker(pp, supertile=enabled)
    server = TileServer(worker)
    await worker.start()
    try:
        lanes = _pan(PANS["composite"])[:16]
        port_ctxs, _ = _both_ctxs(lanes)
        got = await asyncio.gather(*(worker.handle(c) for c in port_ctxs))
        unfused, _ = _both_ctxs(lanes)
        assert [body for body, _ in got] == plain.handle_batch(unfused)
        view = server.health()["supertile"]
        assert view["enabled"] is enabled
        assert worker.snapshot()["batches"] == 1
        assert view["stamped_lanes"] == view["device_lanes"] == (16 if enabled else 0)
        assert view["groups"] == (1 if enabled else 0)
        assert view["encode_groups"] == (4 if enabled else 0)  # one per tile size
    finally:
        await worker.close()
        pp.close()
        plain.close()


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_cuda_composite_carve_matches_cpu(cuda_device, dtype):
    """A 2048 x 2048 three-channel super-tile carved into sixteen 512 x 512
    buckets (and three edge lanes) on the card against the CPU run."""
    spec = RenderSpec.from_params({"c": C_QUERY})
    tables, luts = pe.build_tables(spec, np.dtype(dtype), LutRegistry())
    info = np.iinfo(dtype)
    planes = np.random.default_rng(9).integers(0, info.max, (3, 2048, 2048), dtype=dtype,
                                               endpoint=True)
    coords = [(y, x) for y in range(0, 2048, 512) for x in range(0, 2048, 512)]
    coords += [(1800, 1900), (2047, 0), (0, 2047)]
    cpu = pst.composite_carve_torch(bits_tensor(planes), tables, luts, coords, 512, 512)
    dev = pst.composite_carve_torch(bits_tensor(planes).to(cuda_device), tables, luts, coords,
                                    512, 512)
    assert torch.equal(dev.cpu(), cpu)
