"""The port's multi-device plane against the JAX package's: the mesh
manager (``parallel/mesh.py``) under the same fault points (the same
breaker states per ``device:<index>``, ``last_dispatch``, width-listener
calls and snapshots), its prober, and a ``TilePipeline`` with a 4-slot
mesh over ``cpu`` serving ``/tile`` (``dynamic``, ``rle`` and the
host-deflate route), ``/render``, ``/histogram``, a fused pan and a
full-plane lane larger than every bucket (rows over the mesh), byte-equal
to the JAX pipeline on a 4-device mesh (``tests/conftest.py``) and to the
port's own pipeline without a mesh. A width change re-launches the known
group shapes; a failed distributed lane answers 500 (JAX: a host encode).
Inputs: ``numpy.random.default_rng(53)``. Tolerance: zero."""

import time

import jax
import numpy as np
import pytest

from omero_ms_pixel_buffer_tpu.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JaxRegistry
from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JaxService
from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline as JaxPipeline
from omero_ms_pixel_buffer_tpu.parallel import mesh as jmesh
from omero_ms_pixel_buffer_tpu.render.analysis import HistogramSpec as JaxHist
from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxRender
from omero_ms_pixel_buffer_tpu.render.supertile import assign_supertiles as jax_assign
from omero_ms_pixel_buffer_tpu.resilience import faultinject as jfi
from omero_ms_pixel_buffer_tpu.resilience.breaker import BOARD as JAX_BOARD
from omero_ms_pixel_buffer_tpu.resilience.faultinject import INJECTOR as JAX_INJECTOR
from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx
from omero_ms_pixel_buffer_tpu_torch.errors import InternalError
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.models import tile_pipeline as port_tp
from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import TilePipeline
from omero_ms_pixel_buffer_tpu_torch.parallel import mesh as pmesh
from omero_ms_pixel_buffer_tpu_torch.render.analysis import HistogramSpec
from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
from omero_ms_pixel_buffer_tpu_torch.render.supertile import assign_supertiles
from omero_ms_pixel_buffer_tpu_torch.resilience import faultinject as pfi
from omero_ms_pixel_buffer_tpu_torch.resilience.breaker import BOARD
from omero_ms_pixel_buffer_tpu_torch.resilience.faultinject import INJECTOR, always, first_n
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

# 1200 wide: wider than the largest bucket, so a full-plane PNG lane takes
# the distributed plane route
IMG = np.random.default_rng(53).integers(0, 4096, (1, 3, 2, 160, 1200), dtype=np.uint16)
BUCKETS = (64, 128, 256)


@pytest.fixture(autouse=True)
def _clean():
    for inj, board in ((INJECTOR, BOARD), (JAX_INJECTOR, JAX_BOARD)):
        inj.clear()
        board.reset()
    yield
    for inj, board in ((INJECTOR, BOARD), (JAX_INJECTOR, JAX_BOARD)):
        inj.clear()
        board.reset()


def _states(board, n):
    snap = board.snapshot()
    return [snap.get(f"device:{i}", {}).get("state") for i in range(n)]


SCENARIOS = {
    # fault point -> failures before it heals (None: it keeps failing)
    "one-slot-fails-its-probe": {"device.mesh-dispatch": 1, "device.chip:1": 1},
    "slot-stays-down": {"device.mesh-dispatch": 1, "device.chip:2": None},
    "two-slots-down": {"device.mesh-dispatch": 1, "device.chip:0": None, "device.chip:3": None},
    "every-slot-down": {"device.mesh-dispatch": 1, **{f"device.chip:{i}": None
                                                      for i in range(4)}},
    "healthy": {},
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_mesh_manager_chaos_matches_jax(scenario):
    """The same faults to both managers of four slots: the dispatch's
    outcome, ``last_dispatch``, each ``device:<i>`` breaker's state, the
    width listeners' calls, ``probe_open`` while the fault holds and
    after it clears, and the snapshots agree."""
    outcome = {}
    for name, rules, inj, board, mgr in (
            ("jax", jfi, JAX_INJECTOR, JAX_BOARD, jmesh.MeshManager(devices=jax.devices()[:4])),
            ("port", pfi, INJECTOR, BOARD, pmesh.MeshManager(pmesh.make_mesh(["cpu"] * 4)))):
        for point, count in SCENARIOS[scenario].items():
            err = RuntimeError(point)
            inj.install(point, rules.first_n(count, err) if count else rules.always(err))
        widths = []
        mgr.add_width_listener(widths.append)
        rec = {}
        try:
            rec["result"] = mgr.dispatch(lambda mesh: dict(mesh.shape)["data"], real_lanes=10,
                                         tag="tiles")
        except Exception as e:
            rec["result"] = type(e).__name__
        rec["last"] = mgr.last_dispatch
        rec["states"] = _states(board, 4)
        rec["probe_while_down"] = mgr.probe_open()
        inj.clear()
        rec["probe_after"] = mgr.probe_open()
        rec["states_after"] = _states(board, 4)
        rec["widths"] = widths
        rec["snapshot"] = mgr.snapshot()
        outcome[name] = rec
    assert outcome["port"] == outcome["jax"]


def test_probe_open_skips_healthy_slots():
    mgr = pmesh.MeshManager(pmesh.make_mesh(["cpu"] * 4))
    assert mgr.probe_open() == 0
    assert all(INJECTOR.calls(f"device.chip:{i}") == 0 for i in range(4))


def test_prober_thread_restores_width():
    INJECTOR.install("device.mesh-dispatch", first_n(1, RuntimeError("down")))
    INJECTOR.install("device.chip:2", first_n(1, RuntimeError("down")))
    mgr = pmesh.MeshManager(pmesh.make_mesh(["cpu"] * 4))
    widths = []
    mgr.add_width_listener(widths.append)
    mgr.dispatch(lambda mesh: mesh.size)
    assert mgr.mesh().size == 3 and mgr.last_dispatch["device_ids"] == [0, 1, 3]
    prober = pmesh.MeshProber(lambda: mgr, interval_s=0.02)
    prober.start()
    try:
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and len(mgr.healthy_slots()) < 4:
            time.sleep(0.02)
    finally:
        prober.stop()
    assert len(mgr.healthy_slots()) == 4 and widths == [3, 4]
    assert mgr.dispatch(lambda mesh: mesh.size) == 4


def test_lane_counts_match_jax():
    for real in range(0, 20):
        for n in (1, 2, 3, 8):
            assert pmesh.lane_counts(real, n) == jmesh.lane_counts(real, n)


# -- the pipeline on a mesh ------------------------------------------------------------


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "img.ome.tiff")
    write_ome_tiff(path, IMG, tile_size=(64, 64))
    return path


def _jax_pipeline(path, width, **kw):
    reg = JaxRegistry()
    reg.add(1, path)
    pipe = JaxPipeline(JaxService(reg), engine="device", buckets=BUCKETS, **kw)
    pipe.mesh = (None if width is None else
                 jmesh.make_mesh(("data",), devices=jax.devices()[:width]))
    return pipe


def _port_pipeline(path, width, **kw):
    reg = ImageRegistry()
    reg.add(1, path)
    pipe = TilePipeline(PixelsService(reg), buckets=BUCKETS, device="cpu", **kw)
    pipe.mesh = None if width is None else pmesh.make_mesh(["cpu"] * width)
    return pipe


RENDER_Q = {"c": "1|0:3000$FF0000,2|0:4000$00FF00,3$0000FF"}
LANES = [
    # (kind, z, x, y, w, h, extra)
    ("png", 0, 0, 0, 64, 64, None),
    ("png", 1, 128, 32, 100, 80, None),
    ("png", 0, 1150, 110, 50, 50, None),
    ("png", 1, 0, 0, 256, 128, None),
    ("png", 0, 64, 0, 64, 64, None),
    ("raw", 0, 64, 0, 64, 64, None),
    ("tif", 1, 64, 64, 64, 64, None),
    ("png", 0, 0, 0, 0, 0, None),  # the full plane: rows over the mesh
    ("render", 1, 0, 0, 64, 64, RENDER_Q),
    ("render", 0, 300, 40, 100, 90, {"c": "2|0:4095$00FF00", "m": "g"}),
    ("render", 1, 500, 0, 64, 64, {**RENDER_Q, "p": "intmax|0:1"}),
    ("histogram", 0, 0, 0, 128, 128, {"c": "1,3"}),
    ("histogram", 1, 200, 10, 64, 100, {"c": "2"}),
]


def _ctxs(lanes, pan=None):
    port, jx = [], []
    for kind, z, x, y, w, h, extra in lanes:
        fmt = {"png": "png", "raw": None, "tif": "tif"}.get(kind)
        p = TileCtx(1, z, 0, 0, RegionDef(x, y, w, h), format=fmt, omero_session_key="k")
        j = JaxCtx(1, z, 0, 0, JaxRegion(x, y, w, h), format=fmt, omero_session_key="k")
        if kind in ("render", "histogram"):
            p.render, j.render = RenderSpec.from_params(extra), JaxRender.from_params(extra)
            p.format, j.format = p.render.format, j.render.format
        if kind == "histogram":
            p.analysis, j.analysis = HistogramSpec.from_params({}), JaxHist.from_params({})
        port.append(p)
        jx.append(j)
    if pan is not None:
        assert assign_supertiles(port) == jax_assign(jx) == pan
    return port, jx


def _pan_lanes():
    return [("render", 1, 64 * c, 32 * r, 64, 32, RENDER_Q) for r in range(3) for c in range(4)]


@pytest.mark.parametrize("mode", ["dynamic", "rle"])
def test_four_slot_pipeline_matches_jax_four_device_pipeline(image_path, mode):
    """Every route of a 4-slot mesh: equal to the JAX pipeline on a
    4-device mesh and to the port without a mesh; the dispatches ran on
    four slots, and the full-plane lane took the distributed route."""
    jp = _jax_pipeline(image_path, 4, device_deflate=True, device_deflate_mode=mode)
    pp = _port_pipeline(image_path, 4, device_deflate_mode=mode)
    plain = _port_pipeline(image_path, None, device_deflate_mode=mode)
    try:
        for rnd in range(2):
            port_ctxs, jax_ctxs = _ctxs(LANES)
            got = pp.handle_batch(port_ctxs)
            assert all(g is not None for g in got), rnd
            assert got == jp.handle_batch(jax_ctxs), rnd
            assert got == plain.handle_batch(_ctxs(LANES)[0]), rnd
            port_ctxs, jax_ctxs = _ctxs(_pan_lanes(), pan=12)
            got = pp.handle_batch(port_ctxs)
            assert got == jp.handle_batch(jax_ctxs), rnd
            assert got == plain.handle_batch(_ctxs(_pan_lanes())[0]), rnd
        last = pp.last_mesh_dispatch
        assert last["n_devices"] == jp.last_mesh_dispatch["n_devices"] == 4
        assert pp.distributed_lanes == 2
        snap = pp.supertile_snapshot()
        assert snap["device_lanes"] == 24 and snap["fallback_lanes"] == 0
        tags = pp.device_queue_snapshot()
        assert tags["failed"] == 0 and tags["mesh"]["seen_shapes"] >= 1
    finally:
        jp.close()
        pp.close()
        plain.close()


def test_host_deflate_route_shards_the_filter(image_path):
    """``device_deflate=False``: the bucket lanes' filter shards over the
    mesh (``sharded_batch_filter``) and the host deflates, as in JAX."""
    jp = _jax_pipeline(image_path, 4, device_deflate=False)
    pp = _port_pipeline(image_path, 4, device_deflate=False)
    try:
        lanes = [ln for ln in LANES if ln[0] in ("png", "raw")]
        port_ctxs, jax_ctxs = _ctxs(lanes)
        assert pp.handle_batch(port_ctxs) == jp.handle_batch(jax_ctxs)
        # five bucket lanes and the full plane's filtered rows
        assert pp.host_deflate_lanes == 6 and pp.distributed_lanes == 1
    finally:
        jp.close()
        pp.close()


def test_escape_hatch_serves_pan_lanes_independently(image_path):
    """``supertile.mesh: false``: a stamped pan on a mesh is not fused;
    its lanes shard one by one, with the same bytes."""
    jp = _jax_pipeline(image_path, 4, device_deflate=True, supertile_mesh=False)
    pp = _port_pipeline(image_path, 4, supertile_mesh=False)
    try:
        port_ctxs, jax_ctxs = _ctxs(_pan_lanes(), pan=12)
        assert pp.handle_batch(port_ctxs) == jp.handle_batch(jax_ctxs)
        assert pp.supertile_snapshot()["groups"] == 0
        assert pp.last_mesh_dispatch["tag"] == "render"
    finally:
        jp.close()
        pp.close()


def test_failed_slot_retries_on_the_survivors(image_path):
    """A slot that fails its probe: the group retries at width 3 with the
    same bytes; the width listener warms the known shapes at 3."""
    pp = _port_pipeline(image_path, 4, device_deflate_mode="rle")
    plain = _port_pipeline(image_path, None, device_deflate_mode="rle")
    try:
        lanes = [ln for ln in LANES if ln[0] == "png"][:4]
        want = plain.handle_batch(_ctxs(lanes)[0])
        assert pp.handle_batch(_ctxs(lanes)[0]) == want
        INJECTOR.install("device.mesh-dispatch", first_n(1, RuntimeError("wedged")))
        INJECTOR.install("device.chip:1", always(RuntimeError("down")))
        assert pp.handle_batch(_ctxs(lanes)[0]) == want
        last = pp.last_mesh_dispatch
        assert last["n_devices"] == 3 and last["device_ids"] == [0, 2, 3]
        thread = pp.dispatcher._warm_thread
        assert thread is not None
        thread.join(30)
        assert {w for w, _ in pp.dispatcher._warmed} == {3}
    finally:
        pp.close()
        plain.close()


def test_failed_distributed_lane_answers_500(image_path, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("halo lost")

    monkeypatch.setattr(port_tp, "distributed_filter_plane", broken)
    pp = _port_pipeline(image_path, 2)
    try:
        out = pp.handle_batch(_ctxs([("png", 0, 0, 0, 0, 0, None)])[0])
        assert isinstance(out[0], InternalError)
    finally:
        pp.close()


def test_auto_builds_no_mesh_on_the_cpu(image_path):
    pp = _port_pipeline(image_path, None)
    pp.mesh = "auto"
    try:
        assert pp._get_mesh() is None and pp.mesh_manager() is None
        assert pp.dispatcher.mesh_manager is None
    finally:
        pp.close()
