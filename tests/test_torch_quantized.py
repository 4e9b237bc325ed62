"""Float and 32-bit images through ``/render`` and ``/histogram``: the
port's ``handle_batch`` against the JAX package's (``engine="device"``,
device deflate on, single device), byte for byte.

The images are OME-TIFFs of float32, int32 and uint32 pixels (C = 3,
Z = 3, zlib tiles). Their channels are quantized onto the 16-bit bin
space on the host (``_stage_stack``) and render through tables over it:
windowed composites, greyscale, LUTs, z projections, a lane larger than
every bucket (the host mirror), JPEG, a stamped 3x3 super-tile pan
(fused, also against the port's own unfused lanes), and histograms at
256 and 65536 bins with the type range and with the data's range. A
float render without an explicit window answers None (404) in both;
32-bit integers fall back to their type range. Tolerance: zero (bytes
and statuses)."""

import numpy as np
import pytest

import omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline as port_tp
from omero_ms_pixel_buffer_tpu_torch.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.render import analysis as pa
from omero_ms_pixel_buffer_tpu_torch.render import supertile as pst
from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

SHAPE = (1, 3, 3, 150, 200)  # T, C, Z, Y, X
BUCKETS = (64, 128)
WINDOWED = "1|-200:3000$FF0000,2|0:40000$00FF00,3|500:9000$0000FF"
# (kind, query, z, c, region)
LANES = [
    ("render", {"c": WINDOWED}, 0, 0, (0, 0, 64, 64)),
    ("render", {"c": WINDOWED}, 1, 0, (30, 20, 100, 90)),
    ("render", {"c": "2|0:40000", "m": "g"}, 2, 0, (64, 64, 64, 64)),
    ("render", {"c": "1|-500:5000$fire,3|0:8000$00FFFF"}, 0, 0, (10, 70, 60, 50)),
    ("render", {"c": "1|0:4000$FF0000,2|0:40000$00FF00", "p": "intmax|0:2"}, 0, 0,
     (0, 0, 128, 128)),
    ("render", {"c": "3|500:9000$FFFFFF", "p": "intmean"}, 0, 0, (64, 0, 64, 64)),
    ("render", {"c": WINDOWED}, 0, 0, (0, 0, 200, 150)),  # > every bucket: host mirror
    ("render", {"c": WINDOWED, "format": "jpeg", "q": "0.9"}, 1, 0, (0, 0, 64, 64)),
    ("render", {"c": "1,2"}, 0, 0, (0, 0, 64, 64)),  # no windows: 404 for a float
    ("render", {"c": "1|0:1$FF0000", "maps": '[{"reverse": {"enabled": true}}]'}, 1, 0,
     (5, 5, 40, 40)),
    ("hist", {"bins": "256"}, 0, 0, (0, 0, 64, 64)),
    ("hist", {"bins": "65536", "c": "1,2,3"}, 1, 0, (30, 20, 100, 90)),
    ("hist", {"bins": "256", "usePixelsTypeRange": "1", "c": "2,3"}, 2, 1, (0, 0, 0, 0)),
    ("hist", {"bins": "1000", "c": "3"}, 0, 2, (64, 64, 64, 64)),
]


def _data(dtype):
    rng = np.random.default_rng(29)
    yy, xx = np.mgrid[0:SHAPE[3], 0:SHAPE[4]].astype(np.float64)
    out = np.empty(SHAPE, np.float64)
    for c in range(3):
        for z in range(3):
            out[0, c, z] = (2000 * (c + 1) * np.sin(xx / (17 + 5 * c) + z)
                            * np.cos(yy / 23) + rng.normal(0, 300, xx.shape))
    if dtype == "u4":
        out = np.abs(out) * 7
    elif dtype == "i4":
        out = out * 11
    return out.astype(dtype)


@pytest.fixture(scope="module", params=["f4", "i4", "u4"])
def image(request, tmp_path_factory):
    data = _data(request.param)
    path = str(tmp_path_factory.mktemp("quant") / f"img_{request.param}.ome.tiff")
    write_ome_tiff(path, data, tile_size=(64, 64), compression="zlib")
    return path, np.dtype(request.param)


def _pipelines(path, **kw):
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JR
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JS
    from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline as JP

    jreg, preg = JR(), ImageRegistry()
    jreg.add(1, path)
    preg.add(1, path)
    jax = JP(JS(jreg), engine="device", buckets=BUCKETS, device_deflate=True)
    jax.mesh = None
    port = port_tp.TilePipeline(PixelsService(preg), buckets=BUCKETS, device="cpu", **kw)
    return jax, port


def _ctxs(lanes):
    from omero_ms_pixel_buffer_tpu.render.analysis import HistogramSpec as JaxHist
    from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxRender
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
    from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx

    port, jax = [], []
    for kind, query, z, c, region in lanes:
        p = TileCtx(1, z, c, 0, RegionDef(*region), format="png", omero_session_key="k")
        j = JaxCtx(1, z, c, 0, JaxRegion(*region), format="png", omero_session_key="k")
        if kind == "hist":
            p.analysis = pa.HistogramSpec.from_params(query, default_channel=c)
            j.analysis = JaxHist.from_params(query, default_channel=c)
            p.format = j.format = "json"
        else:
            p.render, j.render = RenderSpec.from_params(query, c), JaxRender.from_params(query, c)
            p.format, j.format = p.render.format, j.render.format
        port.append(p)
        jax.append(j)
    return port, jax


def test_render_and_histogram_lanes_equal_jax(image):
    path, dtype = image
    jax, port = _pipelines(path)
    try:
        for rnd in range(2):  # the second round reuses the table memos
            pc, jc = _ctxs(LANES)
            got, want = port.handle_batch(pc), jax.handle_batch(jc)
            for lane, g, w in zip(LANES, got, want):
                assert g == w, (rnd, lane)
            no_window = LANES.index(("render", {"c": "1,2"}, 0, 0, (0, 0, 64, 64)))
            if dtype.kind == "f":
                assert got[no_window] is None
            assert sum(g is None for g in got) == (1 if dtype.kind == "f" else 0)
        assert port.analysis_snapshot()["device_lanes"] > 0
    finally:
        port.close()


def _pan(query):
    from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxRender
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
    from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx

    port, jax = [], []
    for y, h in ((0, 56), (56, 56), (112, 38)):
        for x, w in ((8, 64), (72, 64), (136, 64)):
            port.append(TileCtx(1, 1, 0, 0, RegionDef(x, y, w, h), format="png",
                                omero_session_key="k", render=RenderSpec.from_params(query)))
            jax.append(JaxCtx(1, 1, 0, 0, JaxRegion(x, y, w, h), format="png",
                              omero_session_key="k", render=JaxRender.from_params(query)))
    return port, jax


@pytest.mark.parametrize("query", [{"c": WINDOWED}, {"c": "2|0:40000", "p": "intmax"},
                                   {"c": WINDOWED, "format": "jpeg"}],
                         ids=["composite", "intmax", "jpeg"])
def test_stamped_pan_equals_jax_and_unfused(image, query):
    from omero_ms_pixel_buffer_tpu.render.supertile import assign_supertiles as jax_assign

    path, _ = image
    jax, port = _pipelines(path)
    unfused_pipe = port_tp.TilePipeline(port.pixels_service, buckets=BUCKETS, device="cpu")
    try:
        pc, jc = _pan(query)
        assert pst.assign_supertiles(pc) == jax_assign(jc) == 9
        got, want = port.handle_batch(pc), jax.handle_batch(jc)
        assert got == want and all(isinstance(g, bytes) for g in got)
        unfused, _ = _pan(query)
        assert unfused_pipe.handle_batch(unfused) == got
        st = port.supertile_snapshot()
        assert st["groups"] == 1 and st["fallback_lanes"] == 0
    finally:
        port.close()
        unfused_pipe.close()
