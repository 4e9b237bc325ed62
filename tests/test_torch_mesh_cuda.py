"""Two mesh slots on one card (``cuda``-marked; it skips without one): the
sharded one-pass chain with each bit packer and the sharded render
chain (``parallel/sharding.py``) launch the kernels once per slot and
give the single-device chain's bytes on the same lanes. No JAX import,
so it runs where only PyTorch is installed (``python -m pytest
tests/test_torch_mesh_cuda.py -m cuda --noconftest``). Inputs:
``numpy.random.default_rng(41)``. Tolerance: zero."""

import numpy as np
import pytest
import torch

from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate as pdd
from omero_ms_pixel_buffer_tpu_torch.ops.convert import bits_tensor
from omero_ms_pixel_buffer_tpu_torch.ops.kernels import reset_launch_counts, slot_launch_counts
from omero_ms_pixel_buffer_tpu_torch.parallel import sharding as psh
from omero_ms_pixel_buffer_tpu_torch.parallel.mesh import make_mesh
from omero_ms_pixel_buffer_tpu_torch.render import engine as pe
from omero_ms_pixel_buffer_tpu_torch.render.luts import LutRegistry
from omero_ms_pixel_buffer_tpu_torch.render.model import RenderSpec

rng = np.random.default_rng(41)
RUNS = rng.integers(0, 4096, (5, 24, 40), dtype=np.uint16)
RUNS[2] = 0
PLANES = rng.integers(0, 65536, (5, 3, 32, 32), dtype=np.uint16)
SPEC = {"c": "1|500:30000$FF0000,2|1000:40000$00FF00,3$fire"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same_streams(want, got, real):
    ws, wl = (t.cpu().numpy() for t in want)
    gs, gl = (t.cpu().numpy() for t in got)
    np.testing.assert_array_equal(gl[:real], wl[:real])
    for b in range(real):
        assert bytes(gs[b, :gl[b]]) == bytes(ws[b, :wl[b]]), b


@pytest.mark.cuda
@pytest.mark.parametrize("packer", ["pallas", "pallas_dense"])
def test_cuda_two_slots_on_one_card_match_the_chain(cuda_device, packer):
    mesh = make_mesh([cuda_device, cuda_device])
    reset_launch_counts()
    tiles, real = psh.pad_batch(bits_tensor(RUNS), 2)
    got = psh.sharded_filter_deflate(mesh, tiles, 24, 81, 2, packer=packer)
    want = pdd.fused_filter_deflate_batch(bits_tensor(RUNS).to(cuda_device), 24, 81, 2,
                                          packer=packer)
    _same_streams(want, got, real)
    counts = slot_launch_counts()
    assert counts.get(0, 0) >= 2 and counts.get(1, 0) >= 2
    tables, luts = pe.build_tables(RenderSpec.from_params(SPEC), np.dtype(np.uint16),
                                   LutRegistry())
    planes, real = psh.pad_batch(bits_tensor(PLANES), 2)
    got = psh.sharded_render_filter_deflate(mesh, planes, tables, luts, 30, 91, packer=packer)
    want = pe.fused_render_filter_deflate_batch(bits_tensor(PLANES).to(cuda_device), tables,
                                                luts, 30, 91, packer=packer)
    _same_streams(want, got, real)
