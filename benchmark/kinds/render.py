"""``/render`` PNG requests: the RGB composite of every channel of one z
plane, with the session's channel windows and colours (OMERO's
rendering model, ``reference/composite.py``)."""

from __future__ import annotations

import numpy as np

from reference.composite import composite, parse_channels


def session(rng, config: dict, traffic: dict) -> dict:
    """A viewer's own windows (one per channel, drawn from the mix's
    ranges) and its colours (distinct, from the mix's palette)."""
    parts = []
    colors = rng.permutation(len(traffic["colors"]))
    for c, window in enumerate(traffic["windows"]):
        start = int(rng.integers(window["start"][0], window["start"][1] + 1))
        end = int(rng.integers(window["end"][0], window["end"][1] + 1))
        parts.append(f"{c + 1}|{start}:{end}${traffic['colors'][colors[c]]}")
    return {"channels": ",".join(parts)}


def planes(config: dict) -> list:
    """The planes one request touches: every channel of a z plane."""
    img = config["image"]
    return [[(c, z) for c in range(img["size_c"])] for z in range(img["size_z"])]


def place(rng, config: dict, spec: dict) -> dict:
    spec["z"] = int(rng.integers(config["image"]["size_z"]))
    return spec


def path(config: dict, spec: dict) -> str:
    return (f"/render/{config['image']['id']}/{spec['z']}/0/0"
            f"?x={spec['x']}&y={spec['y']}&w={spec['w']}&h={spec['h']}"
            f"&c={spec['channels']}&format=png")


def png_format(config: dict) -> tuple:
    return 8, 2


def lane(config: dict, spec: dict) -> tuple:
    return spec["h"], spec["w"] * 3


def _region(data: np.ndarray, spec: dict) -> np.ndarray:
    x, y, w, h = spec["x"], spec["y"], spec["w"], spec["h"]
    return data[:, spec["z"], y:y + h, x:x + w]


def expected(data: np.ndarray, spec: dict) -> np.ndarray:
    return composite(_region(data, spec), parse_channels(spec["channels"]))


def control(data: np.ndarray, spec: dict) -> np.ndarray:
    """The composite of pixels stored as float16."""
    return composite(_region(data, spec), parse_channels(spec["channels"]),
                     pixel_dtype=np.float16)
