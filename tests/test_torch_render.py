"""The port's render engine against the JAX package's, piece by piece: the
``RenderSpec`` parse (signature, JSON form, 400 messages), the LUT
registry (built-ins, ``.lut`` files, a directory), ROI masks (grammar,
rasters, bucket batches, the raster cache), ``build_tables`` over every
quantization family, reverse, greyscale and the 8/16-bit pixel types,
``render_torch`` against ``render_local`` and ``render_host``,
``project_torch`` against ``_project_device`` and ``project_np`` over z
and t stacks, ``zlib_rle_np``, and the fused render chain
(``fused_render_filter_deflate_batch``) in ``rle`` and ``stored`` with
every packer's plain version, with and without a mask, bucket-padded.
Inputs are made from seeds with numpy; the JAX side runs on the CPU with
its ``scan`` packer (its Pallas packers run only in interpret mode).
Tolerance: zero (bytes and integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu.errors import BadRequestError as JaxBadRequest
from omero_ms_pixel_buffer_tpu.ops import device_deflate as jdd
from omero_ms_pixel_buffer_tpu.render import engine as je
from omero_ms_pixel_buffer_tpu.render import luts as jl
from omero_ms_pixel_buffer_tpu.render import masks as jm
from omero_ms_pixel_buffer_tpu.render import projection as jp
from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxSpec
from omero_ms_pixel_buffer_tpu_torch.errors import BadRequestError
from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as pdd
from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
from omero_ms_pixel_buffer_tpu_torch.render import engine as pe
from omero_ms_pixel_buffer_tpu_torch.render import luts as pl
from omero_ms_pixel_buffer_tpu_torch.render import masks as pm
from omero_ms_pixel_buffer_tpu_torch.render import projection as pp
from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec

RECT = '{"type": "rect", "x": 3, "y": 4, "w": 20.5, "h": 9}'
SHAPES = ('[{"type": "rect", "x": 3, "y": 4, "w": 20.5, "h": 9},'
          ' {"type": "ellipse", "cx": 30, "cy": 12, "rx": 9, "ry": 5.5},'
          ' {"type": "polygon", "points": [[1, 1], [40, 3], [22, 30]]},'
          ' {"type": "polyline", "points": [[0, 20], [47, 25], [10, 31]], "width": 3}]')

# the JAX test suite's parse cases, valid then malformed, and the ROI grammar's
VALID = [
    {"c": "1|100:600$FF0000,-2,3|0:4095$00FF00", "m": "c"},
    {"c": "1|-100:200$fire"},
    {"c": "1$FF0000AA"},
    {"c": "1,2", "maps": '[{"reverse": {"enabled": true}}, {"quantization": '
                         '{"family": "exponential", "coefficient": 1.5}}]'},
    {},
    {"p": "intmax|2:5"},
    {"p": "intmean"},
    {"p": "intmax:t"},
    {"p": "intmean:z|0:2"},
    {"format": "jpg", "q": "0.75"},
    {"c": "2|0:10$00FF00,1|0:20$FF0000"},
    {"c": "1|5:99$cool-lut,3|0:10$0000FF", "m": "g", "p": "intmean|0:2",
     "format": "jpeg", "q": "0.5", "maps": '[{"reverse": {"enabled": true}}]'},
    {"c": "1", "maps": '[{"quantization": {"family": "logarithmic", "coefficient": 4}}]'},
    {"c": "1", "maps": '[{"quantization": {"family": "polynomial", "coefficient": 0.5}}]'},
    {"c": "1,2", "maps": '[null]'},
    {"c": "1", "roi": SHAPES},
    {"c": "1", "roi": RECT},
]
MALFORMED = [
    {"c": "xx"}, {"c": "0"}, {"c": "1|9:1"}, {"c": "1,1"},
    {"c": "1", "maps": "{not json"},
    {"c": "1", "maps": '[{"quantization": {"family": "poly"}}]'},
    {"c": "1", "maps": '[{"quantization": {"coefficient": -1}}]'},
    {"c": "1", "maps": '[{"quantization": {"coefficient": "x"}}]'},
    {"c": "1", "maps": '{"a": 1}'},
    {"m": "z"}, {"p": "wat"}, {"p": "intmax|5:2"}, {"q": "2"}, {"q": "0"}, {"q": "x"},
    {"format": "bmp"}, {"c": "-1,-2"}, {"c": ",,"},
    {"roi": "[]"}, {"roi": "{bad"}, {"roi": '[{"type": "star"}]'},
    {"roi": '[{"type": "rect", "w": 0, "h": 1}]'},
    {"roi": '[{"type": "rect", "w": 1, "h": 1, "colour": 3}]'},
    {"roi": '[{"type": "ellipse", "cx": 1, "cy": 1, "rx": -1, "ry": 1}]'},
    {"roi": '[{"type": "polygon", "points": [[0, 0], [1, 1]]}]'},
    {"roi": '[{"type": "polyline", "points": [[0, 0], [1]]}]'},
    {"roi": '[{"type": "polyline", "points": [[0, 0], [1, 1]], "width": 0}]'},
    {"roi": '[{"type": "rect", "x": "nan", "w": 1, "h": 1}]'},
    {"roi": "[" + ",".join([RECT] * 65) + "]"},
]


@pytest.mark.parametrize("params", VALID, ids=range(len(VALID)))
def test_spec_parse_matches_jax(params):
    for default in (0, 2):
        p = RenderSpec.from_params(params, default_channel=default, default_quality=80)
        j = JaxSpec.from_params(params, default_channel=default, default_quality=80)
        assert p.signature() == j.signature()
        assert p.to_json() == j.to_json()
        assert RenderSpec.from_json(p.to_json()) == p
        for size in (1, 3, 4, 8):
            for z, t in ((0, 0), (2, 1)):
                try:
                    want = j.plane_range(z, t, size, size)
                except ValueError:
                    with pytest.raises(ValueError):
                        p.plane_range(z, t, size, size)
                    continue
                assert p.plane_range(z, t, size, size) == want
        assert p.without_windows().signature() == j.without_windows().signature()


@pytest.mark.parametrize("params", MALFORMED, ids=range(len(MALFORMED)))
def test_spec_400_messages_match_jax(params):
    with pytest.raises(JaxBadRequest) as want:
        JaxSpec.from_params(params)
    with pytest.raises(BadRequestError) as got:
        RenderSpec.from_params(params)
    assert (got.value.code, got.value.message) == (want.value.code, want.value.message)


def test_resolve_channels_matches_jax():
    for params in ({"c": "1,4"}, {"c": "3,1", "m": "g"}, {}):
        p, j = RenderSpec.from_params(params), JaxSpec.from_params(params)
        for size_c in (1, 3, 4):
            try:
                want = [c.index for c in j.resolve_channels(size_c)]
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    p.resolve_channels(size_c)
                assert str(got.value) == str(e)
                continue
            assert [c.index for c in p.resolve_channels(size_c)] == want


# -- LUTs ---------------------------------------------------------------------


def test_builtin_luts_match_jax():
    p, j = pl.builtin_luts(), jl.builtin_luts()
    assert sorted(p) == sorted(j)
    for name in j:
        np.testing.assert_array_equal(p[name], j[name])


def test_lut_files_match_jax(tmp_path):
    rng = np.random.default_rng(21)
    table = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    pl.write_imagej_lut(str(tmp_path / "Cool.lut"), table)
    with open(tmp_path / "nih.LUT", "wb") as f:
        f.write(b"ICOL" + bytes(28) + table[::-1].T.tobytes())
    with open(tmp_path / "bad.lut", "wb") as f:
        f.write(b"short")
    (tmp_path / "notes.txt").write_text("not a LUT")
    p, j = pl.LutRegistry(str(tmp_path)), jl.LutRegistry(str(tmp_path))
    assert p.names() == j.names() and len(p) == len(j)
    for name in ("cool", "COOL.lut", "nih", "Nih.lut", "bad", "fire", "nope"):
        assert (name in p) == (name in j)
        if name in j:
            np.testing.assert_array_equal(p.get(name), j.get(name))
    np.testing.assert_array_equal(p.get("cool"), table)
    with pytest.raises(pl.LutError):
        pl.load_imagej_lut(str(tmp_path / "bad.lut"))


# -- ROI masks ----------------------------------------------------------------


@pytest.mark.parametrize("region", [(0, 0, 48, 32), (5, 9, 17, 40), (-3, 20, 31, 7)])
def test_rasterize_matches_jax(region):
    pshapes, jshapes = pm.parse_roi(SHAPES), jm.parse_roi(SHAPES)
    assert pm.mask_signature(pshapes) == jm.mask_signature(jshapes)
    for k in range(1, len(pshapes) + 1):
        got = pm.rasterize(pshapes[:k], *region)
        np.testing.assert_array_equal(got, jm.rasterize(jshapes[:k], *region))
        assert got.dtype == np.uint8
    assert got.any() and not got.all()


def test_bucket_mask_batch_and_cache_match_jax():
    pshapes, jshapes = pm.parse_roi(SHAPES), jm.parse_roi(SHAPES)
    regions = [(0, 0, 48, 32), (8, 4, 20, 30), (1, 1, 64, 64)]
    got = pm.bucket_mask_batch([pm.rasterize(pshapes, *r) for r in regions], 64, 64)
    want = jm.bucket_mask_batch([jm.rasterize(jshapes, *r) for r in regions], 64, 64)
    np.testing.assert_array_equal(got, want)
    pc, jc = pm.MaskRasterCache(max_bytes=5000), jm.MaskRasterCache(max_bytes=5000)
    for image, r in [(1, regions[0]), (1, regions[1]), (1, regions[0]), (2, regions[2]),
                     (1, regions[1])]:
        np.testing.assert_array_equal(pc.get(image, pshapes, r), jc.get(image, jshapes, r))
    assert pc.snapshot() == jc.snapshot()
    assert pc.invalidate_image(1) == jc.invalidate_image(1)
    assert pc.snapshot() == jc.snapshot()


# -- tables ---------------------------------------------------------------------

FAMILIES = [
    {},
    {"maps": '[{"reverse": {"enabled": true}}]'},
    {"maps": '[{"quantization": {"family": "exponential", "coefficient": 2.2}}]'},
    {"maps": '[{"quantization": {"family": "polynomial", "coefficient": 0.45}},'
             ' {"reverse": {"enabled": true}, "quantization": {"family": "logarithmic",'
             ' "coefficient": 7}}]'},
    {"maps": '[{"reverse": {"enabled": true}, "quantization": {"family": "logarithmic",'
             ' "coefficient": 0.3}}]'},
    {"m": "g"},
]
CHANNELS = ["1|10:200$FF8000,2|-50:90$00FFFF,3$fire", "2,1,3", "1|-30000:30000$spectrum",
            "3|3:4$ice"]


@pytest.mark.parametrize("dtype", ["uint8", "int8", "uint16", "int16"])
@pytest.mark.parametrize("family", range(len(FAMILIES)))
@pytest.mark.parametrize("channels", CHANNELS)
def test_build_tables_match_jax(dtype, family, channels):
    params = {"c": channels, **FAMILIES[family]}
    p = pe.build_tables(RenderSpec.from_params(params), np.dtype(dtype), pl.LutRegistry())
    j = je.build_tables(JaxSpec.from_params(params), np.dtype(dtype), jl.LutRegistry())
    for got, want in zip(p, j):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_build_tables_errors_match_jax():
    for params, dtype in (({"c": "1$nope"}, "uint8"), ({}, "float32"),
                          ({"c": ",".join(str(i) for i in range(1, 18))}, "uint8")):
        with pytest.raises(je.RenderError) as want:
            je.build_tables(JaxSpec.from_params(params), np.dtype(dtype), jl.LutRegistry())
        with pytest.raises(pe.RenderError) as got:
            pe.build_tables(RenderSpec.from_params(params), np.dtype(dtype), pl.LutRegistry())
        assert str(got.value) == str(want.value)


def test_quantize_to_u16_matches_jax():
    rng = np.random.default_rng(4)
    plane = rng.normal(0, 1e4, (30, 40)).astype(np.float32)
    plane[0, :4] = [np.nan, np.inf, -np.inf, 0]
    for window in ((-1e4, 1e4), (0.5, 0.75), (-3e4, 0)):
        np.testing.assert_array_equal(pe.quantize_to_u16(plane, window),
                                      je.quantize_to_u16(plane, window))
    for dt in ("uint8", "int16", "float32", "int32", "uint32", "float64", "int64"):
        dt = np.dtype(dt)
        assert pe.renderable_dtype(dt) == je.renderable_dtype(dt)
        assert pe.quantizable_dtype(dt) == je.quantizable_dtype(dt)
        if dt.kind in "ui":
            assert pe.default_window(dt) == je.default_window(dt)


# -- the composite ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["uint8", "int8", "uint16", "int16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("params", [{"c": CHANNELS[0]}, {"c": CHANNELS[0], "m": "g"},
                                    {"c": "1,2", **FAMILIES[3]}])
def test_render_torch_matches_render_local_and_host(dtype, masked, params):
    rng = np.random.default_rng(8)
    info = np.iinfo(dtype)
    planes = rng.integers(info.min, info.max, (3, 3, 24, 40), dtype=dtype, endpoint=True)
    tables, luts = je.build_tables(JaxSpec.from_params(params), np.dtype(dtype), jl.LutRegistry())
    mask = rng.integers(0, 2, (3, 24, 40), dtype=np.uint8) if masked else None
    unsigned = je.unsigned_view(planes)
    want = np.asarray(je.render_local(jnp.asarray(unsigned), jnp.asarray(tables),
                                      jnp.asarray(luts),
                                      None if mask is None else jnp.asarray(mask)))
    got = pe.render_torch(bits_tensor(planes), tables, luts,
                          None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.uint8 and got.shape == (3, 24, 40, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(3):
        host = pe.render_host(unsigned[b], tables, luts, None if mask is None else mask[b])
        np.testing.assert_array_equal(host, want[b])
        np.testing.assert_array_equal(
            host, je.render_host(unsigned[b], tables, luts, None if mask is None else mask[b]))


def test_packed_tables_hold_sixteen_saturated_channels():
    """The packed value -> RGB table sums 16 channels of 255 without a
    carry between colours."""
    tables = np.full((16, 256), 255, np.uint8)
    luts = np.full((16, 256, 3), 255, np.uint8)
    planes = torch.zeros((1, 16, 2, 3), dtype=torch.uint8)
    out = pe.render_torch(planes, tables, luts)
    assert (out == 255).all()
    luts[:, :, 1] = 0
    np.testing.assert_array_equal(pe.render_torch(planes, tables, luts)[..., 1].numpy(), 0)


# -- projection -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["uint8", "int8", "uint16", "int16"])
@pytest.mark.parametrize("mode", ["intmax", "intmean"])
@pytest.mark.parametrize("axis", ["z", "t"])
def test_project_torch_matches_jax(dtype, mode, axis):
    """A (C, T, Z, H, W) stack projected over the planes the spec's
    ``plane_range`` names: the z stack at fixed t, or the t series at
    fixed z."""
    rng = np.random.default_rng(13)
    info = np.iinfo(dtype)
    data = rng.integers(info.min, info.max, (2, 3, 4, 17, 23), dtype=dtype, endpoint=True)
    spec = RenderSpec.from_params({"c": "1,2", "p": f"{mode}:{axis}|1:3"})
    jspec = JaxSpec.from_params({"c": "1,2", "p": f"{mode}:{axis}|1:3"})
    zts = spec.plane_range(2, 1, 4, 3)
    assert zts == jspec.plane_range(2, 1, 4, 3)
    stack = np.stack([np.stack([data[c, t, z] for z, t in zts]) for c in range(2)])
    want = np.asarray(jp._project_device(jnp.asarray(stack), mode))
    got = pp.project_torch(bits_tensor(stack), mode, signed=np.dtype(dtype).kind == "i")
    np.testing.assert_array_equal(got.numpy().view(dtype), want)
    np.testing.assert_array_equal(pp.project_np(stack, mode), want)
    np.testing.assert_array_equal(pp.project_np(stack, mode), jp.project_np(stack, mode))
    one = stack[:, :1]
    np.testing.assert_array_equal(pp.project_torch(bits_tensor(one), mode).numpy().view(dtype),
                                  np.asarray(jp.project_jax(jnp.asarray(one), mode)))
    with pytest.raises(ValueError):
        pp.project_np(stack, "median")


# -- the host twin of the rle stream ------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 258, 259, 1000, 65535, 65536, 200_000])
def test_zlib_rle_np_matches_jax(n):
    rng = np.random.default_rng(n)
    cases = [rng.integers(0, 256, n, dtype=np.uint8),
             np.repeat(rng.integers(0, 3, n // 5 + 1, dtype=np.uint8), 5)[:n],
             np.zeros(n, np.uint8)]
    for data in cases:
        got = pdd.zlib_rle_np(data)
        assert got == jdd.zlib_rle_np(data) == pdd.zlib_rle_np(data.tobytes())
        streams, lengths = pdd.zlib_rle_batch(torch.from_numpy(data)[None], packer="scan")
        assert bytes(streams[0, : int(lengths[0])].numpy()) == got
    with pytest.raises(ValueError):
        pdd.zlib_rle_np(b"")


# -- the fused render chain ------------------------------------------------------------


@pytest.fixture(scope="module")
def render_group():
    """Five lanes of a 3-channel uint16 group, 40 x 28 real pixels in a
    64 x 64 bucket (padding nonzero: it must not reach the bytes), its
    tables and a mask."""
    rng = np.random.default_rng(31)
    planes = rng.integers(0, 65536, (5, 3, 64, 64), dtype=np.uint16)
    spec = {"c": "1|500:30000$FF0000,2|1000:40000$00FF00,3$fire",
            "maps": '[{"reverse": {"enabled": true}}]'}
    tables, luts = je.build_tables(JaxSpec.from_params(spec), np.dtype(np.uint16),
                                   jl.LutRegistry())
    shapes = jm.parse_roi(SHAPES)
    mask = jm.bucket_mask_batch([jm.rasterize(shapes, 8 * b, 3, 40, 28) for b in range(5)],
                                64, 64)
    return planes, tables, luts, mask


@pytest.mark.parametrize("mode", ["rle", "stored"])
@pytest.mark.parametrize("packer", ["scan", "pallas", "pallas_dense"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fmode", ["up", "paeth"])
def test_fused_render_chain_matches_jax(render_group, mode, packer, masked, fmode):
    planes, tables, luts, mask = render_group
    w, h = 40, 28
    m = mask if masked else None
    want_s, want_l = je.fused_render_filter_deflate_batch(
        planes, tables, luts, h, 1 + 3 * w, fmode, mode, "scan",
        None if m is None else jnp.asarray(m))
    got_s, got_l = pe.fused_render_filter_deflate_batch(
        bits_tensor(planes), tables, luts, h, 1 + 3 * w, fmode, mode, packer,
        None if m is None else torch.from_numpy(m))
    want_l, got_l = np.asarray(want_l), got_l.numpy()
    np.testing.assert_array_equal(got_l, want_l)
    for b in range(planes.shape[0]):
        stream = bytes(got_s[b, : got_l[b]].numpy())
        assert stream == bytes(np.asarray(want_s[b, : want_l[b]]))
        if mode == "rle":
            png = pe.render_png_host(planes[b, :, :h, :w], tables, luts, fmode,
                                     None if m is None else m[b, :h, :w])
            assert png == pe.frame_png(stream, w, h, 8, 2)
            assert png == je.render_png_host(planes[b, :, :h, :w], tables, luts, fmode,
                                             None if m is None else m[b, :h, :w])


def test_fused_render_chain_rejects_dynamic(render_group):
    planes, tables, luts, _ = render_group
    with pytest.raises(ValueError):
        pe.fused_render_filter_deflate_batch(bits_tensor(planes), tables, luts, 4, 13,
                                             mode="dynamic")


def test_png_from_rgb_host_matches_jax():
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (19, 33, 3), dtype=np.uint8)
    for fmode in ("none", "sub", "up", "average", "paeth"):
        assert pe.png_from_rgb_host(rgb, fmode) == je.png_from_rgb_host(rgb, fmode)
    assert pe.encode_jpeg(rgb, 75) == je.encode_jpeg(rgb, 75)
