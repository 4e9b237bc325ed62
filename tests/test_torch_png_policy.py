"""The configurable PNG policy (``backend.png`` filter, level, strategy)
of the port against the JAX package's, on the CPU.

- ``filter_rows_np`` in all six modes (``adaptive`` included) at filter
  units 1, 2, 3 and 6.
- ``encode_png`` for 6 filters x levels {0, 1, 6, 9} x strategies
  {fast, default, rle, filtered, huffman} on grey uint16 and RGB uint8
  tiles, with Python zlib and through the native engine's
  ``png_encode_batch`` and ``png_assemble_batch`` (None in both for a
  filter the engine lacks): byte-equal, and each decodes to its pixels.
  ``fast`` is the native in-house coder (code 100) but ``Z_RLE`` in
  Python zlib, so the two routes differ, in both packages alike.
- ``encode_signature`` (the cache key's and the ETag's quality part).
- The device engine's ``handle_batch`` under ``paeth``, ``adaptive`` and
  three other policies, with device deflate on and off and the native
  engine as found and forced off, over three rounds (the plane cache cold,
  admitted, warm): PNG lanes (one larger than every bucket), raw lanes and
  render lanes, byte-equal to the JAX device engine's. ``adaptive`` PNG
  lanes take the host route by configuration (no encode group, counted in
  ``host_png_lanes``), where JAX's device group fails and its lanes are
  re-encoded on the host; render lanes filter ``up`` under it.
- ``/tile`` and ``/render`` through both fronts with ``png.filter:
  paeth`` and ``adaptive`` (level 9, strategy ``default``): equal
  statuses, bodies, ``ETag`` and ``X-Cache``, and ETags that differ from
  the ``up`` policy's.

Tolerance: zero (bytes, statuses and header values)."""

import numpy as np
import pytest

import omero_ms_pixel_buffer_tpu.models.tile_pipeline as jax_tp
import omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline as port_tp
from omero_ms_pixel_buffer_tpu.ops import png as jpng
from omero_ms_pixel_buffer_tpu.runtime import native as jax_native
from omero_ms_pixel_buffer_tpu_torch.io.ometiff import write_ome_tiff
from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.ops import png as ppng
from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec
from omero_ms_pixel_buffer_tpu_torch.runtime import native as port_native
from omero_ms_pixel_buffer_tpu_torch.tile_ctx import RegionDef, TileCtx
from test_torch_host_engine import COOKIE, ConfigFronts, base_config

FILTERS = ("none", "sub", "up", "average", "paeth", "adaptive")
LEVELS = (0, 1, 6, 9)
STRATEGIES = ("fast", "default", "rle", "filtered", "huffman")
_RNG = np.random.default_rng(13)
_YY, _XX = np.mgrid[0:37, 0:53]
TILES = {
    "grey16": (2000 + 900 * np.sin(_XX / 7.0) + 700 * np.cos(_YY / 5.0)
               + _RNG.normal(0, 40, (37, 53))).astype(np.uint16),
    "rgb8": _RNG.integers(0, 256, (29, 31, 3), dtype=np.uint8),
}


@pytest.mark.parametrize("bpp", [1, 2, 3, 6])
@pytest.mark.parametrize("mode", FILTERS)
def test_filter_rows_match_jax(mode, bpp):
    rows = np.random.default_rng(bpp).integers(0, 256, (23, bpp * 17), dtype=np.uint8)
    got = ppng.filter_rows_np(rows, bpp, mode)
    np.testing.assert_array_equal(got, jpng.filter_rows_np(rows, bpp, mode))
    if mode == "adaptive":
        assert len(set(got[:, 0].tolist())) > 1  # filters chosen per row


def test_unknown_filter_raises_in_both():
    rows = np.zeros((2, 4), np.uint8)
    for fn in (ppng.filter_rows_np, jpng.filter_rows_np):
        with pytest.raises(ValueError, match="Unknown filter mode"):
            fn(rows, 1, "bogus")


def _native_pair():
    port, jax = port_native.get_engine(), jax_native.get_engine()
    assert (port is None) == (jax is None)
    return port, jax


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("mode", FILTERS)
def test_encode_png_matches_jax(mode, level, strategy):
    port_eng, jax_eng = _native_pair()
    for name, tile in TILES.items():
        got = ppng.encode_png(tile, mode, level, strategy)
        assert got == jpng.encode_png(tile, mode, level, strategy), name
        np.testing.assert_array_equal(jpng.decode_png(got), tile)
        if port_eng is None:
            continue
        native = port_eng.png_encode_batch([tile], mode, level, strategy)
        assert native == jax_eng.png_encode_batch([tile], mode, level, strategy), name
        assert (native is None) == (mode not in ("none", "sub", "up")), name
        if native is not None:
            np.testing.assert_array_equal(jpng.decode_png(native[0]), tile)
            if strategy == "fast":
                assert native[0] != got  # the in-house coder, not Z_RLE
        # the assemble half: filtered scanlines deflated at the policy
        rows = np.ascontiguousarray(tile.astype(tile.dtype.newbyteorder(">")))
        rows = rows.view(np.uint8).reshape(tile.shape[0], -1)
        bpp = (3 if tile.ndim == 3 else 1) * tile.dtype.itemsize
        payload = ppng.filter_rows_np(rows, bpp, mode).tobytes()
        args = ([payload], [tile.shape[1]], [tile.shape[0]], [tile.dtype.itemsize * 8],
                [2 if tile.ndim == 3 else 0])
        assembled = port_eng.png_assemble_batch(*args, level=level, strategy=strategy)
        assert assembled == jax_eng.png_assemble_batch(*args, level=level, strategy=strategy)
        np.testing.assert_array_equal(jpng.decode_png(assembled[0]), tile)


@pytest.mark.parametrize("policy", [("up", 6, "fast"), ("paeth", 9, "default"),
                                    ("adaptive", 1, "rle"), ("none", 0, "huffman")])
def test_encode_signature_matches_jax(policy, tmp_path):
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JaxRegistry
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JaxService

    f, lvl, strat = policy
    jax_pipe = jax_tp.TilePipeline(JaxService(JaxRegistry()), engine="host", png_filter=f,
                                   png_level=lvl, png_strategy=strat)
    for engine in ("device", "host"):
        port = port_tp.TilePipeline(PixelsService(ImageRegistry()), engine=engine,
                                    device="cpu", png_filter=f, png_level=lvl,
                                    png_strategy=strat)
        assert port.encode_signature() == jax_pipe.encode_signature() == f"{f}.{lvl}.{strat}"
        port.close()
    jax_pipe.close()


# -- the device engine's batches -----------------------------------------------------

SHAPE = (1, 3, 2, 160, 224)  # T, C, Z, Y, X
BUCKETS = (64, 128)


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    data = np.random.default_rng(29).integers(0, 4096, SHAPE, dtype=np.uint16)
    path = str(tmp_path_factory.mktemp("png_policy") / "img.ome.tiff")
    write_ome_tiff(path, data, tile_size=(64, 64), compression="zlib")
    return path, data


@pytest.fixture(params=["native", "python"])
def engine_state(request, monkeypatch):
    """Both packages' native host engine as found, or forced to None."""
    if request.param == "python":
        monkeypatch.setattr(jax_tp, "get_engine", lambda: None)
        monkeypatch.setattr(port_tp, "get_engine", lambda: None)
    elif port_native.get_engine() is None:
        pytest.skip("the native engine does not build here")
    return request.param


def _lanes():
    """(JAX ctxs, port ctxs): PNG lanes (one larger than every bucket),
    a raw lane and three render lanes."""
    from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxRender
    from omero_ms_pixel_buffer_tpu.tile_ctx import RegionDef as JaxRegion
    from omero_ms_pixel_buffer_tpu.tile_ctx import TileCtx as JaxCtx

    spec = [(0, 0, (0, 0, 64, 64), "png", None), (1, 1, (64, 64, 64, 64), "png", None),
            (0, 2, (10, 20, 50, 30), "png", None), (1, 0, (0, 0, 200, 150), "png", None),
            (0, 0, (0, 64, 64, 64), None, None),
            (0, 0, (0, 0, 64, 64), "png", {"c": "1|0:4000$FF0000,2|0:3000$00FF00"}),
            (1, 0, (64, 0, 100, 60), "png", {"c": "2|100:3000", "m": "g"}),
            (0, 0, (0, 0, 64, 64), "png", {"c": "1,3", "p": "intmax"})]
    jax, port = [], []
    for z, c, region, fmt, query in spec:
        j = JaxCtx(1, z, c, 0, JaxRegion(*region), format=fmt, omero_session_key="k")
        p = TileCtx(1, z, c, 0, RegionDef(*region), format=fmt, omero_session_key="k")
        if query is not None:
            j.render, p.render = JaxRender.from_params(query), RenderSpec.from_params(query)
        jax.append(j)
        port.append(p)
    return jax, port


@pytest.mark.parametrize("device_deflate", [True, False], ids=["device-deflate", "host-deflate"])
@pytest.mark.parametrize("policy", [("paeth", 6, "fast"), ("adaptive", 9, "default"),
                                    ("none", 1, "rle"), ("sub", 0, "huffman"),
                                    ("average", 6, "filtered")],
                         ids=lambda p: ".".join(map(str, p)))
def test_device_engine_batches_match_jax(image, engine_state, policy, device_deflate):
    from omero_ms_pixel_buffer_tpu.io.pixels_service import ImageRegistry as JaxRegistry
    from omero_ms_pixel_buffer_tpu.io.pixels_service import PixelsService as JaxService
    from omero_ms_pixel_buffer_tpu.ops.png import decode_png

    path, data = image
    f, lvl, strat = policy
    jreg, reg = JaxRegistry(), ImageRegistry()
    jreg.add(1, path)
    reg.add(1, path)
    kw = dict(png_filter=f, png_level=lvl, png_strategy=strat, buckets=BUCKETS,
              device_deflate=device_deflate)
    jax_pipe = jax_tp.TilePipeline(JaxService(jreg), engine="device", **kw)
    jax_pipe.mesh = None
    port = port_tp.TilePipeline(PixelsService(reg), device="cpu", **kw)
    try:
        for rnd in range(3):  # the plane cache cold, admitted, warm
            jctx, pctx = _lanes()
            got = port.handle_batch(pctx)
            assert got == jax_pipe.handle_batch(jctx), rnd
            assert all(isinstance(b, bytes) for b in got)
            for ctx, body in zip(pctx[:4], got[:4]):
                r = ctx.region
                want = data[0, ctx.c, ctx.z, r.y:r.y + r.height, r.x:r.x + r.width]
                np.testing.assert_array_equal(decode_png(body), want)
                types = _filter_types(body)
                if f == "adaptive":
                    assert len(types) > 1
                else:
                    assert types == {ppng.FILTER_CODES[f]}
            # render lanes filter with the policy's device filter
            assert _filter_types(got[5]) == {ppng.FILTER_CODES.get(f, ppng.FILTER_UP)}
        if f == "adaptive":  # every PNG lane, by configuration
            assert port.host_png_lanes == 3 * 4
            assert port.host_deflate_lanes == 0
        else:  # the lane larger than every bucket
            assert port.host_png_lanes == 3
    finally:
        jax_pipe.close()
        port.close()


def _filter_types(body: bytes) -> set:
    """The set of filter-type bytes over a PNG's scanlines."""
    import struct
    import zlib

    pos, idat = 8, b""
    while pos < len(body):
        (n,) = struct.unpack(">I", body[pos:pos + 4])
        tag = body[pos + 4:pos + 8]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[pos + 8:pos + 18])
        elif tag == b"IDAT":
            idat += body[pos + 8:pos + 8 + n]
        pos += 12 + n
    row = 1 + w * (3 if color == 2 else 1) * depth // 8
    raw = zlib.decompress(idat)
    return {raw[i * row] for i in range(h)}


# -- through both fronts -------------------------------------------------------------

URLS = ["/tile/1/0/0/0?x=0&y=0&w=64&h=64&format=png",
        "/tile/1/1/2/0?x=30&y=20&w=100&h=60&format=png",
        "/tile/1/0/0/0?w=0&h=0&format=png",
        "/render/1/0/0/0?c=1|0:4000$FF0000,2|0:4000$00FF00&x=64&y=0&w=64&h=64",
        "/render/1/1/0/0?c=2|100:3000&m=g&x=0&y=64&w=100&h=80"]


@pytest.mark.parametrize("png", [{"filter": "paeth"},
                                 {"filter": "adaptive", "level": 9, "strategy": "default"}],
                         ids=["paeth", "adaptive.9.default"])
async def test_fronts_match_jax_under_the_policy(image, png):
    """Both fronts on the device engine with the policy: each URL twice
    (miss, hit), equal answers. A tile's ETag is not the ``up`` policy's;
    a render's is, under ``adaptive`` alone (its lanes filter ``up``)."""
    path, _ = image
    raw = base_config(backend={"engine": "device", "png": png})
    f = await ConfigFronts().start(raw, {1: path})
    up = await ConfigFronts().start(base_config(backend={"engine": "device"}), {1: path})
    try:
        assert f.port.pipeline.encode_signature() == f.jax_app.pipeline.encode_signature()
        for url in URLS:
            first = await f.both("GET", url, COOKIE)
            second = await f.both("GET", url, COOKIE)
            assert first[0] == 200 and second[1]["x-cache"] == "hit"
            same = url.startswith("/render/") and png["filter"] == "adaptive"
            up_etag = (await up.both("GET", url, COOKIE))[1]["etag"]
            assert (first[1]["etag"] == up_etag) == same, url
    finally:
        await f.close()
        await up.close()
