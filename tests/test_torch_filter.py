"""The port's PNG filter (plain version on the CPU, CUDA kernel on the
card) against the JAX package's Pallas filter (interpret mode off the
TPU) and its XLA ``png.filter_batch``. Tolerance: zero — the filtered
scanlines are the payload of a byte-exact zlib stream."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu.ops.convert import to_big_endian_bytes as jax_be
from omero_ms_pixel_buffer_tpu.ops.pallas import filter_tiles as pallas_filter
from omero_ms_pixel_buffer_tpu.ops.png import filter_batch as jax_filter_batch
from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
from omero_ms_pixel_buffer_tpu_torch.ops.kernels.filter import (
    filter_tiles,
    filter_tiles_plain,
)

MODES = ["none", "sub", "up", "average", "paeth"]
DTYPES = [np.uint8, np.int8, np.uint16, np.int16]


def _tiles(dtype, samples, seed=5):
    rng = np.random.default_rng(seed)
    info = np.iinfo(dtype)
    shape = (2, 13, 21) + ((samples,) if samples > 1 else ())  # odd H, W
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


@pytest.mark.parametrize("samples", [1, 3], ids=["gray", "rgb"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("mode", MODES)
def test_matches_pallas_and_xla(mode, dtype, samples):
    tiles = _tiles(dtype, samples)
    got = filter_tiles(bits_tensor(tiles), mode).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(pallas_filter(jnp.asarray(tiles), mode))
    )
    rows = jax_be(jnp.asarray(tiles)).reshape(tiles.shape[0], tiles.shape[1], -1)
    bpp = samples * np.dtype(dtype).itemsize
    np.testing.assert_array_equal(
        got, np.asarray(jax_filter_batch(rows, bpp, mode))
    )


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
