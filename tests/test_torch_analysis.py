"""The port's histogram plane (``render/analysis.py`` and the histogram
lanes of ``TilePipeline.handle_batch``) against the JAX package, on the
CPU.

- ``HistogramSpec.from_params``: every 400 message, ``signature``,
  ``to_json`` and ``from_json`` equal the JAX package's.
- ``build_bin_table``, ``resolve_window`` and ``quant_bin_table`` equal
  for uint8, int8, uint16 and int16 under windows and
  ``usePixelsTypeRange``.
- ``histogram_torch`` (the CPU run of the device program) equals JAX
  ``histogram_batch`` (jitted on the CPU) and ``histogram_host`` on
  seeded planes of the four types with negative values, at bins 2, 256
  and 65536; ``stats_from_counts`` and ``histogram_body`` bytes equal.
- ``handle_batch`` on mixed ``/tile``, ``/render`` and ``/histogram``
  batches (a lone histogram, a full plane, a 413, a bad channel, a
  region off the plane) equals JAX ``handle_batch`` (engine ``device``).
- A failed device histogram answers 500.
- ``cuda``: the histogram on the card equals its CPU run.

JAX is imported inside the tests and fixtures that use it, so the
``cuda`` case also runs where only PyTorch is installed (``python -m
pytest tests/test_torch_analysis.py -m cuda --noconftest``). Tolerance:
zero (counts, statuses and bytes)."""

import numpy as np
import pytest
import torch

import omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline as port_tp
from omero_ms_pixel_buffer_tpu_torch.errors import BadRequestError, InternalError
from omero_ms_pixel_buffer_tpu_torch.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
from omero_ms_pixel_buffer_tpu_torch.render import analysis as pa
from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx

DTYPES = ["u1", "i1", "u2", "i2"]
SHAPE = (1, 3, 2, 120, 150)  # T, C, Z, Y, X
BUDGET = 50_000  # max_tile_bytes: a full-plane three-channel histogram is over it


def _planes(dtype, n=3, h=40, w=50, seed=0):
    """Seeded planes spanning the type's range, negative values included."""
    info = np.iinfo(dtype)
    return np.random.default_rng(seed).integers(info.min, info.max, (n, h, w), dtype=dtype,
                                                endpoint=True)


# -- the spec ---------------------------------------------------------------------------

SPEC_ERRORS = [
    ({"bins": "1"}, {}), ({"bins": "abc"}, {}), ({"bins": "65537"}, {}),
    ({"bins": "0"}, {}), ({"bins": ""}, {}), ({"bins": "200"}, {"max_bins": 100}),
    ({"c": ""}, {}), ({"c": ","}, {}), ({"c": "1,1"}, {}), ({"c": "2|0:9,2"}, {}),
    ({"c": "-1,-2"}, {}), ({"c": "zz"}, {}), ({"c": "1|9:1"}, {}),
    ({"c": "1", "maps": "not json"}, {}), ({}, {"default_channel": -1}), ({"c": "1|0:9e3"}, {}),
]
SPECS = [
    ({}, {}), ({}, {"default_channel": 2}), ({"bins": "2"}, {}), ({"bins": "65536"}, {}),
    ({"c": "3,1|100:600,-2"}, {}), ({"c": "1|-5.5:9000", "usePixelsTypeRange": "true"}, {}),
    ({"usePixelsTypeRange": "1", "bins": "17"}, {}), ({"usePixelsTypeRange": "no"}, {}),
    ({"c": "2$FF0000,1|0:4000$fire"}, {}), ({"bins": "300"}, {"max_bins": 300}),
]


@pytest.mark.parametrize("query,kwargs", SPEC_ERRORS, ids=range(len(SPEC_ERRORS)))
def test_spec_400s_match_jax(query, kwargs):
    from omero_ms_pixel_buffer_tpu.errors import BadRequestError as JaxBadRequest
    from omero_ms_pixel_buffer_tpu.render.analysis import HistogramSpec as JaxSpec

    with pytest.raises(JaxBadRequest) as want:
        JaxSpec.from_params(query, **kwargs)
    with pytest.raises(BadRequestError) as got:
        pa.HistogramSpec.from_params(query, **kwargs)
    assert got.value.message == want.value.message


@pytest.mark.parametrize("query,kwargs", SPECS, ids=range(len(SPECS)))
def test_spec_matches_jax(query, kwargs):
    from omero_ms_pixel_buffer_tpu.render.analysis import HistogramSpec as JaxSpec

    got = pa.HistogramSpec.from_params(query, **kwargs)
    want = JaxSpec.from_params(query, **kwargs)
    assert got.signature() == want.signature()
    assert got.to_json() == want.to_json()
    back = pa.HistogramSpec.from_json(got.to_json())
    assert back.signature() == JaxSpec.from_json(want.to_json()).signature()
    assert pa.HistogramSpec.from_json(None) is None
    for size_c in (1, 2, 3):
        try:
            want_ch = want.resolve_channels(size_c)
        except ValueError as e:
            with pytest.raises(ValueError) as err:
                got.resolve_channels(size_c)
            assert str(err.value) == str(e)
            continue
        assert [c.index for c in got.resolve_channels(size_c)] == [c.index for c in want_ch]


# -- tables, reduction, stats, body ------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,upr", [("1", False), ("1", True), ("1|-200:3000", False),
                                   ("1|-200:3000", True), ("1|10:20", False)])
@pytest.mark.parametrize("bins", [2, 256, 65536])
def test_bin_tables_match_jax(dtype, c, upr, bins):
    from omero_ms_pixel_buffer_tpu.render import analysis as ja

    query = {"c": c, "bins": str(bins), "usePixelsTypeRange": "1" if upr else "0"}
    ch = pa.HistogramSpec.from_params(query).channels[0]
    jch = ja.HistogramSpec.from_params(query).channels[0]
    window = pa.resolve_window(ch, np.dtype(dtype), upr)
    assert window == ja.resolve_window(jch, np.dtype(dtype), upr)
    got = pa.build_bin_table(np.dtype(dtype), window, bins)
    want = ja.build_bin_table(np.dtype(dtype), window, bins)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(pa.bin_edges(window, bins), ja.bin_edges(window, bins))


@pytest.mark.parametrize("bins", [2, 256, 65536])
def test_quant_table_and_float_window_match_jax(bins):
    from omero_ms_pixel_buffer_tpu.render import analysis as ja

    assert np.array_equal(pa.quant_bin_table(bins), ja.quant_bin_table(bins))
    plane = np.random.default_rng(bins).normal(0, 30, (20, 20)).astype(np.float32)
    plane[0, 0] = np.nan
    ch = pa.HistogramSpec.from_params({}).channels[0]
    jch = ja.HistogramSpec.from_params({}).channels[0]
    assert (pa.resolve_window(ch, np.dtype("f4"), True, plane)
            == ja.resolve_window(jch, np.dtype("f4"), True, plane))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bins", [2, 256, 65536])
def test_histogram_torch_matches_jax(dtype, bins):
    """The CPU run of the device program, from the unsigned view and from
    the signed pixels themselves, against the jitted JAX program and the
    numpy mirror; then the stats and the JSON body bytes."""
    from omero_ms_pixel_buffer_tpu.render import analysis as ja
    from omero_ms_pixel_buffer_tpu.render.engine import unsigned_view

    planes = _planes(np.dtype(dtype), seed=bins)
    full = pa.resolve_window(pa.HistogramSpec.from_params({}).channels[0], np.dtype(dtype), True)
    tabs = np.stack([pa.build_bin_table(np.dtype(dtype), w, bins)
                     for w in ((-100.0, 3000.0), full, (5.0, 60.0))])
    u = unsigned_view(planes)
    want = ja.histogram_batch(u, tabs, bins)
    assert np.array_equal(want, ja.histogram_host(u, tabs, bins))
    got = pa.histogram_torch(bits_tensor(u), torch.from_numpy(tabs), bins)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    signed = pa.histogram_torch(torch.from_numpy(planes), torch.from_numpy(tabs), bins)
    assert np.array_equal(signed.numpy(), want)
    assert np.array_equal(pa.histogram_batch(u, tabs, bins, torch.device("cpu")), want)
    assert np.array_equal(pa.histogram_host(u, tabs, bins), want)
    assert int(got.sum()) == planes.size
    window = (-100.0, 3000.0)
    spec_q = {"c": "1|-100:3000,2", "bins": str(bins)}
    spec, jspec = pa.HistogramSpec.from_params(spec_q), ja.HistogramSpec.from_params(spec_q)
    chans = []
    for k in range(2):
        stats = pa.stats_from_counts(want[k], window, bins)
        assert stats == ja.stats_from_counts(want[k], window, bins)
        chans.append({"index": k, "window": list(window), "counts": [int(x) for x in want[k]],
                      "stats": stats})
    body = pa.histogram_body(4, 1, 0, (3, 5, 50, 40), None, spec, chans)
    assert body == ja.histogram_body(4, 1, 0, (3, 5, 50, 40), None, jspec, chans)


def test_stats_of_empty_counts_match_jax():
    from omero_ms_pixel_buffer_tpu.render import analysis as ja

    zero = np.zeros(8, np.int32)
    assert pa.stats_from_counts(zero, (0, 1), 8) == ja.stats_from_counts(zero, (0, 1), 8)


# -- the pipeline ----------------------------------------------------------------------


@pytest.fixture(scope="module", params=DTYPES)
def image(request, tmp_path_factory):
    info = np.iinfo(np.dtype(request.param))
    data = np.random.default_rng(11).integers(info.min, info.max, SHAPE,
                                              dtype=np.dtype(request.param), endpoint=True)
    path = str(tmp_path_factory.mktemp("hist") / f"img_{request.param}.ome.tiff")
    write_ome_tiff(path, data, tile_size=(64, 64), compression="zlib")
    return path, data


def _jax_pipeline(path, **kwargs):
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JR
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JS
    from omero_ms_pixel_buffer_tpu.models.tile_pipeline import TilePipeline as JP

    reg = JR()
    reg.add(1, path)
    pipe = JP(JS(reg), engine="device", buckets=(64, 128), max_tile_bytes=BUDGET,
              device_deflate=True, **kwargs)
    pipe.mesh = None
    return pipe


def _port_pipeline(path, **kwargs):
    reg = ImageRegistry()
    reg.add(1, path)
    return port_tp.TilePipeline(PixelsService(reg), buckets=(64, 128), device="cpu",
                                max_tile_bytes=BUDGET, **kwargs)


# (kind, query, z, c, t, region)
LANES = [
    ("hist", {}, 0, 0, 0, (0, 0, 64, 48)),
    ("hist", {"c": "1,2,3", "bins": "2"}, 1, 0, 0, (10, 20, 100, 60)),
    ("hist", {"c": "2|-50:900,3", "bins": "65536"}, 0, 1, 0, (0, 0, 64, 48)),
    ("hist", {"usePixelsTypeRange": "1", "bins": "256"}, 1, 2, 0, (5, 7, 33, 71)),
    ("hist", {"c": "1|10:30"}, 0, 0, 0, (0, 0, 0, 0)),  # the full plane
    ("hist", {"c": "1,2,3"}, 0, 0, 0, (0, 0, 0, 0)),  # over the budget -> 413
    ("hist", {"c": "7"}, 0, 0, 0, (0, 0, 16, 16)),  # channel out of range -> None
    ("hist", {}, 0, 0, 0, (300, 0, 16, 16)),  # region off the plane -> None
    ("hist", {"c": "1,2,3", "bins": "2"}, 1, 0, 0, (10, 20, 100, 60)),  # a duplicate lane
    ("tile", None, 0, 1, 0, (0, 0, 64, 64)),
    ("tile", None, 1, 2, 0, (20, 30, 90, 50)),
    ("render", {"c": "1|0:100$FF0000,2$00FF00"}, 0, 0, 0, (0, 0, 64, 64)),
    ("render", {"c": "3", "p": "intmax"}, 0, 0, 0, (64, 32, 60, 60)),
]


def _ctxs(lanes):
    """The same lanes as port and JAX contexts."""
    from omero_ms_pixel_buffer_tpu.render.analysis import HistogramSpec as JaxHist
    from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxRender
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
    from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx

    port, jax = [], []
    for kind, query, z, c, t, region in lanes:
        p = TileCtx(1, z, c, t, RegionDef(*region), format="png", omero_session_key="k")
        j = JaxCtx(1, z, c, t, JaxRegion(*region), format="png", omero_session_key="k")
        if kind == "hist":
            p.analysis = pa.HistogramSpec.from_params(query, default_channel=c)
            j.analysis = JaxHist.from_params(query, default_channel=c)
            p.format = j.format = "json"
        elif kind == "render":
            p.render, j.render = RenderSpec.from_params(query, c), JaxRender.from_params(query, c)
        port.append(p)
        jax.append(j)
    return port, jax


def _assert_same(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, Exception):
            assert type(g).__name__ == type(w).__name__ and g.code == w.code, (what, i)
            assert g.message == w.message, (what, i)
        else:
            assert g == w, (what, i)


def test_handle_batch_matches_jax(image):
    """Mixed /tile, /render and /histogram lanes, two rounds; then a lone
    histogram through ``handle_batch`` and ``handle``."""
    path, data = image
    jp, pp = _jax_pipeline(path), _port_pipeline(path)
    try:
        for rnd in range(2):
            port_ctxs, jax_ctxs = _ctxs(LANES)
            got = pp.handle_batch(port_ctxs)
            _assert_same(got, jp.handle_batch(jax_ctxs), rnd)
        assert got[5].code == 413 and got[6] is None and got[7] is None
        assert all(isinstance(g, bytes) for g in got[:5])
        for lane in (LANES[1], LANES[4]):
            port_ctxs, jax_ctxs = _ctxs([lane])
            _assert_same(pp.handle_batch(port_ctxs), jp.handle_batch(jax_ctxs), "lone")
            assert pp.handle(port_ctxs[0]) == jp.handle(jax_ctxs[0])
        snap = pp.analysis_snapshot()
        assert snap["hist_tables_cached"] == jp.analysis_snapshot()["hist_tables_cached"]
        assert snap["device"] == "cpu" and snap["device_groups"] > 0
        assert snap["failed_groups"] == 0
    finally:
        jp.close()
        pp.close()


def test_histogram_counts_match_numpy(image):
    """The served counts equal ``np.bincount`` of the source region."""
    import json

    path, data = image
    pp = _port_pipeline(path)
    try:
        query = {"c": "2", "bins": "256", "usePixelsTypeRange": "1"}
        port_ctxs, _ = _ctxs([("hist", query, 1, 0, 0, (10, 20, 100, 60))])
        body = json.loads(pp.handle_batch(port_ctxs)[0])
        region = data[0, 1, 1, 20:80, 10:110].astype(np.float64)
        info = np.iinfo(data.dtype)
        x = (region - info.min) / (float(info.max) - info.min)
        want = np.bincount(np.minimum(np.floor(x * 256), 255).astype(np.int64).ravel(),
                           minlength=256)
        assert body["data"] == body["channels"][0]["counts"] == want.tolist()
    finally:
        pp.close()


def test_failed_device_histogram_answers_500(image, monkeypatch):
    path, _ = image
    pp = _port_pipeline(path)

    def broken(*args):
        raise RuntimeError("histogram program down")

    monkeypatch.setattr(port_tp.ranalysis, "histogram_batch", broken)
    try:
        port_ctxs, _ = _ctxs([LANES[0], LANES[9]])
        out = pp.handle_batch(port_ctxs)
        assert isinstance(out[0], InternalError) and out[0].code == 500
        assert isinstance(out[1], bytes)
        assert pp.analysis_snapshot()["failed_groups"] == 1
    finally:
        pp.close()


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bins", [2, 256, 65536])
def test_cuda_histogram_matches_cpu(cuda_device, dtype, bins):
    planes = _planes(np.dtype(dtype), n=4, h=512, w=512, seed=bins)
    window = pa.resolve_window(pa.HistogramSpec.from_params({}).channels[0],
                               np.dtype(dtype), True)
    tabs = np.stack([pa.build_bin_table(np.dtype(dtype), window, bins)] * 4)
    cpu = pa.histogram_torch(torch.from_numpy(planes), torch.from_numpy(tabs), bins)
    dev = pa.histogram_torch(torch.from_numpy(planes).to(cuda_device),
                             torch.from_numpy(tabs).to(cuda_device), bins)
    assert torch.equal(dev.cpu(), cpu)
