"""The image made from the seed: the port's OME-TIFF reader reads back
the pixels the harness keeps for the reference, plane by plane."""

import numpy as np

from harness import fixture

IMG = {"id": 1, "size_x": 700, "size_y": 600, "size_c": 2, "size_z": 3, "pixel_type": "uint16",
       "tile": 256, "compression": "zlib", "zlib_level": 1, "pyramid_levels": 1}
CONTENT = {"noise_sigma": 50, "channels": [
    {"level": 2000, "amp_x": 900, "period_x": 31.0, "amp_y": 700, "period_y": 17.0,
     "drift_z": 0.7},
    {"level": 9000, "amp_x": 300, "period_x": 13.0, "amp_y": 500, "period_y": 41.0,
     "drift_z": 0.7}]}


def test_reader_reads_back_the_pixels(tmp_path):
    from omero_ms_pixel_buffer_tpu_torch.io.ometiff import OmeTiffPixelBuffer

    path = str(tmp_path / "image.ome.tiff")
    data = fixture.write(path, IMG, CONTENT, 2**31 + 5, 2).data
    assert data.shape == (2, 3, 600, 700)
    assert np.array_equal(data, fixture.pixels(IMG, CONTENT, 2**31 + 5, 2).data)
    buf = OmeTiffPixelBuffer(path, image_id=1)
    try:
        for z in range(3):
            for c in range(2):
                got = buf.get_tile_at(0, z, c, 0, 0, 0, 700, 600)
                assert np.array_equal(got, data[c, z]), (z, c)
        assert not np.array_equal(data[0, 0], data[0, 1])  # the planes differ
    finally:
        buf.close()
