"""Fault for the harness's test: an answer altered where it is produced.
The PNG filter's output of every device encode group has its first
filtered byte flipped, so the first column of each lane decodes wrong."""

from omero_ms_pixel_buffer_tpu_torch.ops import device_deflate

_filter_tiles = device_deflate.filter_tiles


def filter_tiles(tiles, mode="up"):
    out = _filter_tiles(tiles, mode).clone()
    out[:, 0, 1] ^= 1
    return out


device_deflate.filter_tiles = filter_tiles
