"""The port's sharded programs (``parallel/sharding.py``) against the JAX
package's ``shard_map`` programs: every function at n in {1, 2, 3, 8}
slots over ``cpu``, byte-equal to the JAX function on a mesh over the
first n of the 8 virtual CPU devices (``tests/conftest.py``), on the
same seeded inputs (``numpy.random.default_rng(41)``); the same for
``plan_mesh_partition`` and ``sharded_histogram_batch``. Streams are
compared per lane up to their lengths (the buffers' widths are each
package's own). The card's case, two slots on one device against the
single-device chain, is ``tests/test_torch_mesh_cuda.py``. Tolerance:
zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu.ops.device_deflate import build_dynamic_tables
from omero_ms_pixel_buffer_tpu.parallel import mesh as jmesh
from omero_ms_pixel_buffer_tpu.parallel import sharding as jsh
from omero_ms_pixel_buffer_tpu.render import analysis as jan
from omero_ms_pixel_buffer_tpu.render import engine as je
from omero_ms_pixel_buffer_tpu.render import luts as jl
from omero_ms_pixel_buffer_tpu.render import supertile as jst
from omero_ms_pixel_buffer_tpu.render.model import RenderSpec as JaxSpec
from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as pdd
from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
from omero_ms_pixel_buffer_tpu_torch.parallel import sharding as psh
from omero_ms_pixel_buffer_tpu_torch.parallel.mesh import make_mesh
from omero_ms_pixel_buffer_tpu_torch.render import analysis as pan
from omero_ms_pixel_buffer_tpu_torch.render import supertile as pst

WIDTHS = [1, 2, 3, 8]
rng = np.random.default_rng(41)
GREY = rng.integers(0, 65536, (5, 24, 40), dtype=np.uint16)
RGB = rng.integers(0, 256, (7, 16, 20, 3), dtype=np.uint8)
SMOOTH = (np.add.outer(np.arange(24), np.arange(40)) * 37 % 4096).astype(np.uint16)
RUNS = np.stack([SMOOTH, GREY[1], np.zeros_like(SMOOTH), SMOOTH // 16, GREY[3]])
PLANES = rng.integers(0, 65536, (5, 3, 32, 32), dtype=np.uint16)
SPEC = {"c": "1|500:30000$FF0000,2|1000:40000$00FF00,3$fire"}


def _meshes(n):
    return (jmesh.make_mesh(("data",), devices=jax.devices()[:n]),
            make_mesh(["cpu"] * n))


def _jax_padded(jm, x):
    padded, real = jsh.pad_batch(jnp.asarray(x), jm.shape["data"])
    return jsh.shard_batch(jm, padded), real


def _port_padded(pm, x):
    return psh.pad_batch(bits_tensor(np.ascontiguousarray(x)), pm.size)


def _same_streams(jax_out, port_out, real):
    js, jl_ = (np.asarray(a) for a in jax_out)
    ps, pl_ = (a.numpy() for a in port_out)
    np.testing.assert_array_equal(pl_[:real], jl_[:real])
    for b in range(real):
        assert bytes(ps[b, :pl_[b]]) == bytes(js[b, :jl_[b]]), b


@pytest.fixture(scope="module")
def tables():
    return je.build_tables(JaxSpec.from_params(SPEC), np.dtype(np.uint16), jl.LutRegistry())


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("tiles,bpp", [(GREY, 2), (RGB, 3)], ids=["grey16", "rgb8"])
@pytest.mark.parametrize("mode", ["up", "paeth"])
def test_batch_filter_matches_jax(n, tiles, bpp, mode):
    jm, pm = _meshes(n)
    jx, real = _jax_padded(jm, tiles)
    want = np.asarray(jsh.sharded_batch_filter(jm, jx, bpp, mode))[:real]
    px, preal = _port_padded(pm, tiles)
    got = psh.sharded_batch_filter(pm, px, bpp, mode)[:preal]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_distributed_filter_plane_matches_jax(n, dtype):
    """Rows sharded with the one-row halo: equal to the JAX ``ppermute``
    program and to one filter over the whole plane."""
    plane = rng.integers(0, np.iinfo(dtype).max, (6 * n, 37), dtype=dtype)
    jm, pm = _meshes(n)
    want = np.asarray(jsh.distributed_filter_plane(jm, jsh.shard_rows(jm, jnp.asarray(plane))))
    got = psh.distributed_filter_plane(pm, bits_tensor(plane)).numpy()
    np.testing.assert_array_equal(got, want)
    whole = psh.filter_tiles(bits_tensor(plane)[None], "up")[0].numpy()
    np.testing.assert_array_equal(got, whole)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("deflate_mode", ["rle", "stored"])
def test_filter_deflate_matches_jax(n, deflate_mode):
    jm, pm = _meshes(n)
    jx, real = _jax_padded(jm, RUNS)
    want = jsh.sharded_filter_deflate(jm, jx, 20, 1 + 33 * 2, 2, deflate_mode=deflate_mode,
                                      packer="scan")
    px, _ = _port_padded(pm, RUNS)
    got = psh.sharded_filter_deflate(pm, px, 20, 1 + 33 * 2, 2, deflate_mode=deflate_mode)
    _same_streams(want, got, real)


@pytest.mark.parametrize("n", WIDTHS)
def test_dynamic_passes_match_jax(n):
    """Pass 1 (payloads, counts, extra bits), the host plan, pass 2."""
    jm, pm = _meshes(n)
    jx, real = _jax_padded(jm, RUNS)
    jflat, jcounts, jextras = jsh.sharded_filter_histogram(jm, jx, 24, 1 + 40 * 2, 2)
    px, _ = _port_padded(pm, RUNS)
    pflat, pcounts, pextras = psh.sharded_filter_histogram(pm, px, 24, 1 + 40 * 2, 2)
    np.testing.assert_array_equal(pflat.numpy(), np.asarray(jflat))
    np.testing.assert_array_equal(pcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(pextras.numpy(), np.asarray(jextras))
    tabs = build_dynamic_tables(np.asarray(jcounts), np.asarray(jextras), real=real)
    ptabs = pdd.build_dynamic_tables(pcounts.numpy(), pextras.numpy(), real=real)
    for a, b in zip(tabs, ptabs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    want = jsh.sharded_dynamic_emit(jm, jflat, tabs, packer="scan")
    got = psh.sharded_dynamic_emit(pm, pflat, ptabs)
    _same_streams(want, got, real)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("masked", [False, True])
def test_render_filter_deflate_matches_jax(n, masked, tables):
    index_tables, color_luts = tables
    mask = (rng.random((5, 32, 32)) < 0.5).astype(np.uint8) if masked else None
    jm, pm = _meshes(n)
    jx, real = _jax_padded(jm, PLANES)
    jmask = None if mask is None else jsh.shard_batch(jm, jsh.pad_batch(jnp.asarray(mask), n)[0])
    want = jsh.sharded_render_filter_deflate(jm, jx, index_tables, color_luts, 30, 1 + 30 * 3,
                                             packer="scan", mask=jmask)
    px, _ = _port_padded(pm, PLANES)
    pmask = None if mask is None else psh.pad_batch(torch.from_numpy(mask), n)[0]
    got = psh.sharded_render_filter_deflate(pm, px, index_tables, color_luts, 30, 1 + 30 * 3,
                                            mask=pmask)
    _same_streams(want, got, real)


RECTS = [(x, y, 24, 20) for y in (0, 20, 40) for x in (0, 24, 48, 72)][:11]


@pytest.mark.parametrize("n", WIDTHS)
def test_plan_mesh_partition_matches_jax(n):
    for rects, h, w in ((RECTS, 60, 96), (RECTS[:1], 20, 24), (RECTS[::-1], 60, 96)):
        want = jst.plan_mesh_partition(rects, h, w, n)
        got = pst.plan_mesh_partition(rects, h, w, n)
        assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("n", WIDTHS)
def test_supertile_carve_deflate_matches_jax(n, tables):
    index_tables, color_luts = tables
    stack = rng.integers(0, 65536, (3, 60, 96), dtype=np.uint16)
    origins, (sh, sw), coords, rows = pst.plan_mesh_partition(RECTS, 60, 96, n)
    sub = np.stack([stack[:, y:y + sh, x:x + sw] for y, x in origins])
    jm, pm = _meshes(n)
    js, jlen = jsh.sharded_supertile_carve_deflate(jm, jnp.asarray(sub), index_tables,
                                                   color_luts, jnp.asarray(coords), 20, 24,
                                                   packer="scan")
    ps, plen = psh.sharded_supertile_carve_deflate(pm, sub, index_tables, color_luts, coords,
                                                   20, 24)
    js, jlen, ps, plen = np.asarray(js), np.asarray(jlen), ps.numpy(), plen.numpy()
    for r in rows:
        assert plen[r] == jlen[r]
        assert bytes(ps[r, :plen[r]]) == bytes(js[r, :jlen[r]])
    # every real lane's stream is the one its unfused encode gives
    for (x, y, w, h), r in zip(RECTS, rows):
        png = je.render_png_host(stack[:, y:y + h, x:x + w], index_tables, color_luts)
        assert png == je.frame_png(bytes(ps[r, :plen[r]]), w, h, 8, 2)


@pytest.mark.parametrize("n", WIDTHS)
def test_sharded_histogram_batch_matches_jax(n):
    planes = rng.integers(0, 65536, (5, 20, 30), dtype=np.uint16)
    tabs = np.stack([jan.build_bin_table(np.dtype(np.uint16), (100.0 * i, 60000.0), 64)
                     for i in range(5)])
    jm, pm = _meshes(n)
    want = jan.sharded_histogram_batch(jm, planes, tabs, 64)
    got = pan.sharded_histogram_batch(pm, planes, tabs, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jan.histogram_host(planes, tabs, 64))


def test_blocks_need_padding_first():
    pm = make_mesh(["cpu"] * 3)
    with pytest.raises(ValueError, match="pad_batch"):
        psh.sharded_batch_filter(pm, bits_tensor(GREY), 2)
