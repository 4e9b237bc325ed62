"""The harness's image, traffic and reference for the configuration and
mixes it had before configurations could ask for pyramid levels, JPEG,
RGB and BigTIFF: the same as then, byte for byte. Each digest was taken
from the harness of that time (zlib 1.2.13's deflate for the file)."""

import hashlib
import json

import pytest

from harness import fixture, manifest, traffic

SEEDS = (3, 2**31 + 11, 987654321)
IMAGE_SEED = 2**31 + 21
SMALL = {"size_x": 2100, "size_y": 1600}
GOLDEN = {
    "plane-png-random": {
        "steps": "58ec4b5a1dab4a49fef134ffb9f668f5b1746cb26e448c5a14878b36badcad9c",
        "warm": "1483d8b7e9d069a8b13601b780d2644b5f28ed7ed33b267fadec632144857fe7",
        "expected": "a249d002b743b77e977fc4910ba059b8d1cb9585dcc84f611ec61dedcab0231a"},
    "render-viewport": {
        "steps": "cb922409bd571967500eaa0f7464d9e7a5e8fc40d836e3cd0664b90d1cdf10dd",
        "warm": "7db38b196eaef08fe72a9341ec6caab39b42224c68ac84a4e642972a70400262",
        "expected": "6e9dcb4186e10e035b14da3ef82bc8514bbec15279a6fe700eeb8657bd19abf2"},
}
FILE = "824aa592df7cf042c692e16aafe4aaf2bfcfedefab54d507016e8c7f29152a76"
FILE_BYTES = 14749018
PIXELS = "3419db5c3a9b4b567e527464a8a7ac52cb1972ada0b6b4e6c8b3c110cbe140e6"


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_paths_samples_and_touches(name):
    """3 seeds x 4 clients x 20 steps: each request's path and sample
    flag; and the warm-up touches of each seed."""
    cell = manifest.resolve(name)
    steps, warm = [], []
    for seed in SEEDS:
        for k in range(4):
            stream = traffic.Client(cell.kind, cell.config, cell.traffic, seed, k)
            for _ in range(20):
                steps.append([[s["path"], s["sample"]] for s in stream.step()])
        warm.append([[s["path"] for s in seq]
                     for seq in traffic.touches(cell.kind, cell.config, cell.traffic, seed)])
    assert _digest(steps) == GOLDEN[name]["steps"]
    assert _digest(warm) == GOLDEN[name]["warm"]


def test_file_and_reference(tmp_path):
    """The file written with the configuration's image keys at a small
    size, the pixels kept for the reference, and the reference of each
    kind's first requests on it."""
    cell = manifest.resolve("plane-png-random")
    img = dict(cell.config["image"], **SMALL)
    path = tmp_path / "image.ome.tiff"
    source = fixture.write(str(path), img, cell.config["content"], IMAGE_SEED, 2)
    assert path.stat().st_size == FILE_BYTES
    assert hashlib.sha256(path.read_bytes()).hexdigest() == FILE
    assert hashlib.sha256(source.data.tobytes()).hexdigest() == PIXELS
    config = dict(cell.config, image=img)
    for name in sorted(GOLDEN):
        kind = manifest.resolve(name).kind
        mix = manifest.resolve(name).traffic
        h = hashlib.sha256()
        for k in range(4):
            stream = traffic.Client(kind, config, mix, IMAGE_SEED, k)
            for _ in range(10):
                for spec in stream.step():
                    h.update(kind.expected(source.level(0), spec).tobytes())
        assert h.hexdigest() == GOLDEN[name]["expected"], name
