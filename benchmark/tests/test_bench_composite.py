"""The plain ``/render`` composite on a case worked out by hand, and the
float16 control on the same pixels."""

import numpy as np

from reference.composite import composite, levels, parse_channels


def test_hand_worked_4x4():
    ch1 = np.tile(np.array([0, 50, 100, 200], np.uint16), (4, 1))  # by column
    ch2 = np.tile(np.array([[50], [100], [150], [0]], np.uint16), (1, 4))  # by row
    channels = parse_channels("1|0:100$FF0000,2|50:150$808080")
    assert channels == [(0, 0.0, 100.0, "FF0000"), (1, 50.0, 150.0, "808080")]
    # channel 1 levels by column: 0, floor(127.5 + 0.5) = 128, 255, 255 (clipped)
    # channel 2 levels by row: 0, 128, 255, 0; tinted by 0x80: 0, 64, 128, 0
    red = np.array([[0, 128, 255, 255],
                    [64, 192, 255, 255],
                    [128, 255, 255, 255],  # 128 + 128 clamps at 255
                    [0, 128, 255, 255]])
    grey = np.array([0, 64, 128, 0])[:, None].repeat(4, axis=1)
    want = np.stack([red, grey, grey], axis=2).astype(np.uint8)
    assert np.array_equal(composite(np.stack([ch1, ch2]), channels), want)


def test_levels_round_half_up_and_clip():
    v = np.array([-5, 0, 1, 50, 99, 100, 1000])
    assert levels(v, 0.0, 100.0).tolist() == [0, 0, 3, 128, 252, 255, 255]


def test_float16_control_differs_above_2048():
    planes = np.arange(2040, 2040 + 32, dtype=np.uint16).reshape(2, 4, 4)
    channels = parse_channels("1|2040:2072$FFFFFF,2|2040:2072$000000")
    assert not np.array_equal(composite(planes, channels),
                              composite(planes, channels, pixel_dtype=np.float16))


def test_table_path_equals_direct_arithmetic():
    rng = np.random.default_rng(3)
    planes = rng.integers(0, 65536, (3, 64, 48), dtype=np.uint16)
    channels = parse_channels("1|500:15000$FF0000,2|9000:35000$FFFF00,3|15000:50000$00FFFF")
    assert np.array_equal(composite(planes, channels),
                          composite(planes, channels, pixel_dtype=np.uint16))
