"""Images with pyramid levels, JPEG RGB tiles and BigTIFF: the port's
OME-TIFF reader reads back, at every level and in every tile, what the
harness's reference holds; the reference is tight enough that the
port's float IDCT fails it; uint8 samples clip; a kind that draws levels
gets whole tiles inside its level."""

import types

import numpy as np
import pytest
from conftest import BENCH

from harness import check, fixture, manifest, traffic

RGB = {"id": 1, "size_x": 1500, "size_y": 1100, "size_c": 3, "size_z": 2, "pixel_type": "uint8",
       "tile": 256, "compression": "jpeg", "jpeg_quality": 90, "samples_per_pixel": 3,
       "bigtiff": True, "pyramid_levels": 3}
CONTENT = {"noise_sigma": 12, "channels": [
    {"level": 120, "amp_x": 60, "period_x": 31.0, "amp_y": 50, "period_y": 17.0, "drift_z": 0.7},
    {"level": 90, "amp_x": 40, "period_x": 13.0, "amp_y": 70, "period_y": 41.0, "drift_z": 0.7},
    {"level": 200, "amp_x": 80, "period_x": 23.0, "amp_y": 30, "period_y": 29.0,
     "drift_z": 0.7}]}
SEED = 2**31 + 40


def _tile_kind():
    return manifest.load_module(BENCH / "kinds" / "tile.py", "bench_kind_tile_test")


def _every_tile(img: dict) -> list:
    """A sampled spec for each tile of each channel, z and level."""
    t, specs = img["tile"], []
    for k in range(img.get("pyramid_levels", 1)):
        size_x, size_y = fixture.level_size(img, k)
        for z in range(img["size_z"]):
            for c in range(img["size_c"]):
                for y in range(0, size_y, t):
                    for x in range(0, size_x, t):
                        specs.append(dict(c=c, z=z, x=x, y=y, w=min(t, size_x - x),
                                          h=min(t, size_y - y), level=k, sample=True))
    return specs


def _port_reads(buf):
    return lambda level, s: buf.get_tile_at(s["level"], s["z"], s["c"], 0, s["x"], s["y"],
                                            s["w"], s["h"])


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:0"])
def test_port_host_idct_equals_reference_float_idct_does_not(tmp_path, monkeypatch, subsampling):
    from omero_ms_pixel_buffer_tpu_torch.io.jpeg import DeviceIdct
    from omero_ms_pixel_buffer_tpu_torch.io.ometiff import OmeTiffPixelBuffer

    img = dict(RGB, jpeg_subsampling=subsampling)
    path = str(tmp_path / "image.ome.tiff")
    source = fixture.write(path, img, CONTENT, SEED, 2)
    with open(path, "rb") as f:
        assert f.read(4) == b"MM\x00+"
    assert source.stats[2]["tiles"] == 2 * 2 * 2 and source.stats[1]["tiles"] == 2 * 3 * 3
    specs = _every_tile(img)
    kind = _tile_kind()
    monkeypatch.delenv("OMPB_JPEG_DEVICE_IDCT", raising=False)
    buf = OmeTiffPixelBuffer(path, image_id=1)
    try:
        assert buf.resolution_levels == 3 and buf.meta.size_c == 3 and buf.meta.size_z == 2
        host = check.judge_arrays(specs, _port_reads(buf), kind, source)
    finally:
        buf.close()
    assert host["compared"] == len(specs) == 2 * 3 * (30 + 9 + 4)
    assert check.verdict(host) and host["wrong_pixels"] == 0
    # the same comparison fed the port's float IDCT (idct_blocks_torch, CPU)
    monkeypatch.setenv("OMPB_JPEG_DEVICE_IDCT", "1")
    buf = OmeTiffPixelBuffer(path, image_id=1, device_idct=DeviceIdct("cpu"))
    try:
        float_idct = check.judge_arrays(specs, _port_reads(buf), kind, source)
    finally:
        buf.close()
        source.close()
    assert not check.verdict(float_idct) and float_idct["wrong_pixels"] > 0


def test_jpeg_reference_holds_no_plane(tmp_path):
    """The reference of a JPEG source decodes only the tiles asked for."""
    source = fixture.write(str(tmp_path / "i.tif"), dict(RGB, jpeg_subsampling="4:2:0"),
                           CONTENT, SEED, 2)
    level = source.level(1)
    assert level.shape == (3, 2, 550, 750)
    rgb = level[:, 1, 300:420, 200:260]
    assert rgb.shape == (3, 120, 60) and np.array_equal(rgb[2], level[2, 1, 300:420, 200:260])
    assert len(source.decoded) == 2 and not hasattr(source, "data")
    with pytest.raises(ValueError):
        fixture.pixels(RGB, CONTENT, SEED, 1)
    source.close()


def test_lossless_levels_are_strided_views(tmp_path):
    """zlib RGB (photometric RGB) and grey uint16 levels: the port reads
    level k as ``[::2**k, ::2**k]`` of the seed's pixels, and the
    reference holds no copy of it."""
    from omero_ms_pixel_buffer_tpu_torch.io.ometiff import OmeTiffPixelBuffer

    grey = dict(RGB, size_c=2, pixel_type="uint16", compression="zlib", zlib_level=1,
                samples_per_pixel=1, bigtiff=False, size_z=1)
    grey_content = dict(CONTENT, channels=[dict(ch, level=ch["level"] * 100)
                                           for ch in CONTENT["channels"][:2]])
    for img, content in ((dict(RGB, compression="zlib", zlib_level=1), CONTENT),
                         (grey, grey_content)):
        path = str(tmp_path / f"{img['pixel_type']}.tif")
        source = fixture.write(path, img, content, SEED, 2)
        assert np.shares_memory(source.level(2), source.data)
        buf = OmeTiffPixelBuffer(path, image_id=1)
        try:
            numbers = check.judge_arrays(_every_tile(img), _port_reads(buf), _tile_kind(), source)
        finally:
            buf.close()
        assert check.verdict(numbers) and numbers["compared"] > 0
        assert np.array_equal(source.data, fixture.pixels(img, content, SEED, 1).data)


def test_uint8_clips_not_wraps():
    img = dict(RGB, compression="zlib", zlib_level=1, samples_per_pixel=1, size_c=2, size_z=1,
               size_x=300, size_y=200)
    content = {"noise_sigma": 1, "channels": [
        dict(CONTENT["channels"][0], level=400, amp_x=0, amp_y=0),
        dict(CONTENT["channels"][0], level=-60, amp_x=0, amp_y=0)]}
    data = fixture.pixels(img, content, SEED, 1).data
    assert (data[0] == 255).all() and (data[1] == 0).all()


def test_level_kind_draws_whole_tiles_of_its_level():
    cell = manifest.resolve("plane-png-random")
    config = dict(cell.config, image=dict(cell.config["image"], pyramid_levels=4))
    mix = dict(cell.traffic, clients=4)
    kind = types.SimpleNamespace(**{k: getattr(cell.kind, k) for k in dir(cell.kind)
                                    if not k.startswith("__")})
    kind.level = lambda rng, config, traffic: int(rng.integers(4))
    levels = set()
    for seed in (1, 2**31 + 7):
        for k in range(mix["clients"]):
            stream = traffic.Client(kind, config, mix, seed, k)
            for _ in range(50):
                (spec,) = stream.step()
                size_x, size_y = fixture.level_size(config["image"], spec["level"])
                assert spec["w"] == spec["h"] == 512
                assert spec["x"] % 64 == 0 and spec["y"] % 64 == 0
                assert spec["x"] + 512 <= size_x and spec["y"] + 512 <= size_y
                levels.add(spec["level"])
        for seq in traffic.touches(kind, config, mix, seed):
            for spec in seq:
                size_x, size_y = fixture.level_size(config["image"], spec["level"])
                assert spec["w"] == spec["h"] == 512
                assert spec["x"] + 512 <= size_x and spec["y"] + 512 <= size_y
    assert levels == {0, 1, 2, 3}
