"""``/tile`` PNG requests of one channel plane: the answer is the source
pixels of the region, lossless."""

from __future__ import annotations

import numpy as np

# the greyscale PNG of the pixel type: (bit depth, colour type)
PNG_FORMAT = {"uint8": (8, 0), "uint16": (16, 0)}


def session(rng, config: dict, traffic: dict) -> dict:
    """Per-client parameters: none for tiles."""
    return {}


def planes(config: dict) -> list:
    """The planes one request touches, as (c, z) pairs, for the warm-up."""
    img = config["image"]
    return [[(c, z)] for c in range(img["size_c"]) for z in range(img["size_z"])]


def place(rng, config: dict, spec: dict) -> dict:
    """Draw the plane of one request."""
    img = config["image"]
    spec["c"] = int(rng.integers(img["size_c"]))
    spec["z"] = int(rng.integers(img["size_z"]))
    return spec


def path(config: dict, spec: dict) -> str:
    return (f"/tile/{config['image']['id']}/{spec['z']}/{spec['c']}/0"
            f"?x={spec['x']}&y={spec['y']}&w={spec['w']}&h={spec['h']}&format=png")


def png_format(config: dict) -> tuple:
    return PNG_FORMAT[config["image"]["pixel_type"]]


def lane(config: dict, spec: dict) -> tuple:
    """(rows, bytes of pixels in a row) of the lane that encodes it."""
    item = np.dtype(config["image"]["pixel_type"]).itemsize
    return spec["h"], spec["w"] * item


def expected(data: np.ndarray, spec: dict) -> np.ndarray:
    """``data`` (C, Z, Y, X) -> the pixels the answer must hold."""
    x, y, w, h = spec["x"], spec["y"], spec["w"], spec["h"]
    return data[spec["c"], spec["z"], y:y + h, x:x + w]


def control(data: np.ndarray, spec: dict) -> np.ndarray:
    """The reference with the pixels stored as float16, the precision
    below the configuration's lossless uint16."""
    return expected(data, spec).astype(np.float16).astype(data.dtype)
