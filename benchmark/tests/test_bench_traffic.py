"""Each traffic mix: the same seed gives the same steps to each client,
another seed others, and the steps have the mix's stated shape."""

import json
import re

import pytest
from conftest import BENCH

from harness import manifest, traffic

CELLS = ["plane-png-random", "render-viewport"]


def _steps(cell, seed, client, n=20):
    stream = traffic.Client(cell.kind, cell.config, cell.traffic, seed, client)
    return [[s["path"] for s in stream.step()] for _ in range(n)]


@pytest.mark.parametrize("name", CELLS)
def test_deterministic_per_seed(name):
    cell = manifest.resolve(name)
    seed = 2**31 + 12345  # seeds run past 32 bits
    assert _steps(cell, seed, 3) == _steps(cell, seed, 3)
    assert _steps(cell, seed, 3) != _steps(cell, seed + 1, 3)
    assert _steps(cell, seed, 3) != _steps(cell, seed, 4)
    warm = traffic.touches(cell.kind, cell.config, cell.traffic, seed)
    assert warm == traffic.touches(cell.kind, cell.config, cell.traffic, seed)


def _geometry(path):
    return {k: int(v) for k, v in re.findall(r"[?&]([xywh])=(\d+)", path)}


def test_plane_png_random_parameters():
    cell = manifest.resolve("plane-png-random")
    mix, img = cell.traffic, cell.config["image"]
    assert (mix["kind"], mix["clients"], mix["cols"], mix["rows"]) == ("tile", 128, 1, 1)
    planes = set()
    for client in range(mix["clients"]):
        stream = traffic.Client(cell.kind, cell.config, mix, 7, client)
        for _ in range(50):
            (spec,) = stream.step()
            g = _geometry(spec["path"])
            assert g["x"] % 64 == 0 and g["y"] % 64 == 0
            assert g["w"] == g["h"] == 512
            assert g["x"] + 512 <= img["size_x"] and g["y"] + 512 <= img["size_y"]
            assert spec["path"].startswith(f"/tile/1/0/{spec['c']}/0?") and "format=png" in spec["path"]
            planes.add(spec["c"])
    assert planes == set(range(img["size_c"]))
    # 149 x 149 positions of 3 channels: ~67k distinct tiles
    top = traffic.origins(cell.config, mix)
    assert (top[0] + 1) * (top[1] + 1) * img["size_c"] == 149 * 149 * 3


def test_render_viewport_parameters():
    cell = manifest.resolve("render-viewport")
    mix, img = cell.traffic, cell.config["image"]
    assert (mix["kind"], mix["clients"], mix["cols"], mix["rows"]) == ("render", 8, 4, 3)
    clipped = 0
    sessions, zs = set(), set()
    for client in range(mix["clients"]):
        stream = traffic.Client(cell.kind, cell.config, mix, 11, client)
        for _ in range(40):
            step = stream.step()
            assert len(step) == 12
            assert len({s["z"] for s in step}) == 1 and len({s["channels"] for s in step}) == 1
            x0, y0 = step[0]["x"], step[0]["y"]
            assert x0 % 512 == 0 and y0 % 512 == 0
            for k, s in enumerate(step):
                assert (s["x"], s["y"]) == (x0 + 512 * (k % 4), y0 + 512 * (k // 4))
                assert s["w"] == min(512, img["size_x"] - s["x"]) > 0
                assert s["h"] == min(512, img["size_y"] - s["y"]) > 0
                clipped += s["w"] < 512 or s["h"] < 512
            sessions.add(step[0]["channels"])
            zs.add(step[0]["z"])
            for c, part in enumerate(step[0]["channels"].split(",")):
                start, end = map(int, part.split("|")[1].split("$")[0].split(":"))
                window = mix["windows"][c]
                assert window["start"][0] <= start <= window["start"][1]
                assert window["end"][0] <= end <= window["end"][1]
            assert len({p.split("$")[1] for p in step[0]["channels"].split(",")}) == 3
    assert clipped > 0  # viewports reach the image's edge
    assert zs == {0} and img["size_z"] == 1
    assert len(sessions) == mix["clients"]  # each viewer its own windows and colours


def test_mixes_are_data():
    for path in (BENCH / "traffic").iterdir():
        assert path.suffix == ".json"
        json.loads(path.read_text())


def test_seeds_share_the_set_of_sessions():
    cell = manifest.resolve("render-viewport")
    n = cell.traffic["clients"]

    def sessions(seed):
        return [traffic.Client(cell.kind, cell.config, cell.traffic, seed, k).session["channels"]
                for k in range(n)]

    a, b = sessions(5), sessions(2**31 + 77)
    assert a != b and sorted(a) == sorted(b) and len(set(a)) == n


def test_warm_up_touches_every_plane_twice():
    for name in CELLS:
        cell = manifest.resolve(name)
        mix, img = cell.traffic, cell.config["image"]
        seqs = traffic.touches(cell.kind, cell.config, mix, 5)
        assert sorted(g for g in cell.kind.planes(cell.config)) == sorted(
            [[(s["c"], s["z"]) for s in seq[:1]] if name == "plane-png-random"
             else [(c, seq[0]["z"]) for c in range(img["size_c"])] for seq in seqs])
        assert all(len(seq) == mix["warm_touches"] for seq in seqs)
        for seq in seqs:
            for s in seq:
                assert (s["w"], s["h"]) == (mix["tile"], mix["tile"])
                assert s["x"] + s["w"] <= img["size_x"] and s["y"] + s["h"] <= img["size_y"]
