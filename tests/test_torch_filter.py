"""The port's PNG filter (plain version on the CPU, CUDA kernel on the
card) against the JAX package's Pallas filter (interpret mode off the
TPU) and its XLA ``png.filter_batch``. Tolerance: zero — the filtered
scanlines are the payload of a byte-exact zlib stream.

The JAX package is imported by the ``jax_ref`` fixture, so that the
``cuda``-marked cases also run where only PyTorch is installed
(``python -m pytest tests/test_torch_filter.py -m cuda --noconftest``)."""

import types

import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
from omero_ms_pixel_buffer_tpu_torch.ops.kernels.filter import (
    filter_tiles,
    filter_tiles_plain,
)

MODES = ["none", "sub", "up", "average", "paeth"]
DTYPES = [np.uint8, np.int8, np.uint16, np.int16]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's Pallas filter, its lane-shape gate and its XLA
    ``png.filter_batch`` over big-endian rows."""
    jnp = pytest.importorskip("jax.numpy")
    from omero_ms_pixel_buffer_tpu.ops.convert import to_big_endian_bytes
    from omero_ms_pixel_buffer_tpu.ops.pallas import filter_tiles, supports
    from omero_ms_pixel_buffer_tpu.ops.png import filter_batch

    def xla(tiles, mode):
        rows = to_big_endian_bytes(jnp.asarray(tiles))
        samples = tiles.shape[3] if tiles.ndim == 4 else 1
        bpp = samples * tiles.dtype.itemsize
        return np.asarray(filter_batch(rows.reshape(tiles.shape[0], tiles.shape[1], -1), bpp, mode))

    return types.SimpleNamespace(
        pallas=lambda tiles, mode: np.asarray(filter_tiles(jnp.asarray(tiles), mode)),
        supports=supports, xla=xla,
    )


def _tiles(dtype, samples, seed=5):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    shape = (2, 13, 21) + ((samples,) if samples > 1 else ())  # odd H, W
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


@pytest.mark.parametrize("samples", [1, 3], ids=["gray", "rgb"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("mode", MODES)
def test_matches_pallas_and_xla(jax_ref, mode, dtype, samples):
    tiles = _tiles(dtype, samples)
    got = filter_tiles(bits_tensor(tiles), mode).numpy()
    np.testing.assert_array_equal(got, jax_ref.pallas(tiles, mode))
    np.testing.assert_array_equal(got, jax_ref.xla(tiles, mode))


# Shapes at the CUDA kernel's edges: each warp owns a group of consecutive
# scanlines (4 at 512 uint16 columns) and walks them in 512-byte column
# steps with 16-byte loads and stores; rows that are not a multiple of 16
# bytes take its byte-load branch.
GEOMETRIES = {
    "pixel_1x1": ((1, 1, 1), np.uint16),
    "h17_groups_straddle_lanes": ((3, 17, 512), np.uint16),  # B*H = 51, 4 rows a group
    "rows_not_multiple_of_group": ((7, 11, 600), np.uint8),
    "rgb16_w21": ((2, 5, 21, 3), np.uint16),  # bpp 6, rows of 126 bytes
    "u16_1024_wide": ((1, 4, 1024), np.uint16),
    "rgba16_bpp8": ((2, 6, 9, 4), np.uint16),
    "rgb16_w16_aligned_rows": ((2, 7, 16, 3), np.uint16),  # bpp 6, rows of 96 bytes
    "rgba8_w36": ((3, 5, 36, 4), np.uint8),  # bpp 4, rows of 144 bytes
    "rgba16_w400_ragged_step": ((1, 4, 400, 4), np.uint16),  # 3,200-byte rows
    "row_80kb": ((1, 3, 40000), np.uint16),  # 157 column steps, the last ragged
}


def _geometry_tiles(name, seed=3):
    shape, dtype = GEOMETRIES[name]
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("mode", MODES)
def test_edge_geometries_match_pallas_and_xla(jax_ref, mode, geometry):
    """Against the Pallas filter where its VMEM gate takes the shape
    (grayscale and RGB), always against ``png.filter_batch``."""
    tiles = _geometry_tiles(geometry)
    samples = tiles.shape[3] if tiles.ndim == 4 else 1
    got = filter_tiles(bits_tensor(tiles), mode).numpy()
    if jax_ref.supports(tiles.shape[1:3], tiles.dtype, samples):
        np.testing.assert_array_equal(got, jax_ref.pallas(tiles, mode))
    np.testing.assert_array_equal(got, jax_ref.xla(tiles, mode))


def test_unsigned_tensor_dtype_is_its_bits():
    tiles = _tiles(np.uint16, 1)
    a = filter_tiles(torch.from_numpy(tiles.astype(np.int32)).to(torch.uint16), "paeth")
    np.testing.assert_array_equal(a.numpy(), filter_tiles(bits_tensor(tiles), "paeth").numpy())


def test_rejects_unknown_mode_and_shape():
    with pytest.raises(ValueError):
        filter_tiles(torch.zeros((1, 4, 4), dtype=torch.uint8), "bogus")
    with pytest.raises(ValueError):
        filter_tiles(torch.zeros((4, 4), dtype=torch.uint8), "up")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("samples", [1, 3], ids=["gray", "rgb"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("mode", MODES)
def test_cuda_kernel_matches_plain(cuda_device, mode, dtype, samples):
    tiles = bits_tensor(_tiles(dtype, samples, seed=11)).to(cuda_device)
    before = filter_tiles.launches
    got = filter_tiles(tiles, mode)
    assert filter_tiles.launches == before + 1
    torch.testing.assert_close(got, filter_tiles_plain(tiles, mode), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("mode", MODES)
def test_cuda_kernel_edge_geometries(cuda_device, mode, geometry):
    tiles = bits_tensor(_geometry_tiles(geometry, seed=13)).to(cuda_device)
    torch.testing.assert_close(
        filter_tiles(tiles, mode), filter_tiles_plain(tiles, mode), rtol=0, atol=0
    )


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_cuda_kernel_misaligned_input(cuda_device, mode):
    """A contiguous uint8 view whose data starts 1 byte past an aligned
    allocation: the kernel's byte-load branch."""
    rng = np.random.default_rng(17)
    flat = torch.from_numpy(rng.integers(0, 256, 1 + 5 * 19 * 37 * 3, dtype=np.uint8))
    tiles = flat.to(cuda_device)[1:].view(5, 19, 37, 3)
    assert tiles.is_contiguous() and tiles.data_ptr() % 16 == 1
    torch.testing.assert_close(
        filter_tiles(tiles, mode), filter_tiles_plain(tiles, mode), rtol=0, atol=0
    )


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_cuda_kernel_main_path_shape(cuda_device, mode):
    """32 lanes of 512x512 uint16, the encode queue's full group."""
    rng = np.random.default_rng(19)
    tiles = bits_tensor(rng.integers(0, 65536, (32, 512, 512), dtype=np.uint16))
    tiles = tiles.to(cuda_device)
    torch.testing.assert_close(
        filter_tiles(tiles, mode), filter_tiles_plain(tiles, mode), rtol=0, atol=0
    )
