"""A configuration's file carries its whole deployment, and a request
kind its answers' format, with no edit of the harness: the server's
``OMPB_*`` environment, a kind that answers raw uint16 bytes, and a
pyramid of JPEG RGB tiles in a BigTIFF served at its levels, each run
whole on the CPU."""

import json
import os
import time

import pytest
from conftest import BENCH

from harness import cell as run_cell
from harness import manifest

PROBE = "OMPB_BENCH_PROBE"
# run first in the server's process: what it was given, beside the checkout
PRELOAD = f"""import json, os
with open("env_seen.json", "w") as f:
    json.dump({{"probe": os.environ.get({PROBE!r}), "pid": os.getpid()}}, f)
"""
# raw answers: no format in the query, big-endian samples in the body
RAW_KIND = '''
import numpy as np


def path(config, spec):
    return (f"/tile/{config['image']['id']}/{spec['z']}/{spec['c']}/0"
            f"?x={spec['x']}&y={spec['y']}&w={spec['w']}&h={spec['h']}")


def answer_problem(config, spec, body):
    want = spec["w"] * spec["h"] * np.dtype(config["image"]["pixel_type"]).itemsize
    return None if len(body) == want else f"{len(body)} raw bytes, not {want}"


def answer_pixels(config, spec, body):
    dtype = np.dtype(config["image"]["pixel_type"]).newbyteorder(">")
    return np.frombuffer(body, dtype).reshape(spec["h"], spec["w"])
'''
LEVEL_KIND = '''

def level(rng, config, traffic):
    return int(rng.integers(config["image"]["pyramid_levels"]))


def path(config, spec):
    return (f"/tile/{config['image']['id']}/{spec['z']}/{spec['c']}/0"
            f"?x={spec['x']}&y={spec['y']}&w={spec['w']}&h={spec['h']}"
            f"&resolution={spec['level']}&format=png")
'''


def _add(root, config=None, mix=None, kind=None, cell="throwaway-cell"):
    """Add a cell whose configuration, mix and kind are new files."""
    bench = root / "benchmark"
    m = json.loads((root / "BENCHMARK.json").read_text())
    names = {"config": "plane-u16-10k", "traffic": "tile-png-random"}
    if config is not None:
        (bench / "configs" / "throwaway-config.json").write_text(json.dumps(config))
        m["configs"].append({"name": "throwaway-config", "source": "a test", "reduced": [],
                             "file": "benchmark/configs/throwaway-config.json", "why": "a test"})
        names["config"] = "throwaway-config"
    if kind is not None:
        (bench / "kinds" / "throwaway_kind.py").write_text(kind)
        mix = dict(mix, kind="throwaway_kind")
    if mix is not None:
        (bench / "traffic" / "throwaway-mix.json").write_text(json.dumps(mix))
        names["traffic"] = "throwaway-mix"
    m["workloads"].append(dict(name=cell, chips=1, why="a test", **names))
    (root / "BENCHMARK.json").write_text(json.dumps(m))


def _config(root) -> dict:
    return json.loads((root / "benchmark" / "configs" / "plane-u16-10k.json").read_text())


def _mix(root, name="tile-png-random") -> dict:
    return json.loads((root / "benchmark" / "traffic" / f"{name}.json").read_text())


def _run(root, capsys, preload=None, seed=6):
    rc = run_cell.run(["--workload", "throwaway-cell", "--seed", str(seed), "--seconds", "3",
                       "--trace", "0"], time.monotonic(), root=root, device="cpu",
                      require_chip=False, preload=preload)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True, err[-3000:]
    return result


def test_server_env_reaches_the_server_only(small_root, capsys):
    _add(small_root, config=dict(_config(small_root), server_env={PROBE: "seen-42"}),
         mix=dict(_mix(small_root), clients=3))
    preload = small_root / "preload.py"
    preload.write_text(PRELOAD)
    result = _run(small_root, capsys, preload)
    seen = json.loads((small_root / "env_seen.json").read_text())
    assert result["correct"] is True and result["attempted"] > 0
    assert seen["probe"] == "seen-42" and seen["pid"] != os.getpid()
    assert PROBE not in os.environ


def test_raw_kind_is_judged_and_no_env_is_added(small_root, capsys):
    """A kind that answers raw uint16 bytes, under a configuration with no
    ``server_env``: the server's environment is the harness's own."""
    _add(small_root, mix=dict(_mix(small_root), clients=3),
         kind=(BENCH / "kinds" / "tile.py").read_text() + RAW_KIND)
    preload = small_root / "preload.py"
    preload.write_text(PRELOAD)
    result = _run(small_root, capsys, preload)
    assert result["correct"] is True and result["compared"] > 0
    assert json.loads((small_root / "env_seen.json").read_text())["probe"] is None
    assert result["metrics"]["wire_bytes_per_tile"]["value"] == 512 * 512 * 2


def test_jpeg_rgb_bigtiff_pyramid_is_served_and_judged(small_root, capsys):
    image = {"id": 1, "size_x": 1500, "size_y": 1100, "size_c": 3, "size_z": 1,
             "pixel_type": "uint8", "tile": 256, "compression": "jpeg", "jpeg_quality": 90,
             "jpeg_subsampling": "4:2:0", "samples_per_pixel": 3, "bigtiff": True,
             "pyramid_levels": 3}
    content = {"noise_sigma": 12, "channels": [
        {"level": 120, "amp_x": 60, "period_x": 31.0, "amp_y": 50, "period_y": 17.0,
         "drift_z": 0.7},
        {"level": 90, "amp_x": 40, "period_x": 13.0, "amp_y": 70, "period_y": 41.0,
         "drift_z": 0.7},
        {"level": 200, "amp_x": 80, "period_x": 23.0, "amp_y": 30, "period_y": 29.0,
         "drift_z": 0.7}]}
    _add(small_root, config=dict(_config(small_root), image=image, content=content),
         mix=dict(_mix(small_root), clients=3, tile=256, sample_share=0.5),
         kind=(BENCH / "kinds" / "tile.py").read_text() + LEVEL_KIND)
    result = _run(small_root, capsys, seed=2**31 + 3)
    assert result["correct"] is True and result["compared"] > 0
    assert result["checks"]["wrong_pixels"]["value"] == 0


@pytest.mark.parametrize("env", [{"PATH": "/x"}, {"OMPB_X": 1}, ["OMPB_X"], {"ompb_x": "1"}])
def test_server_env_names_only_ompb(small_root, env):
    _add(small_root, config=dict(_config(small_root), server_env=env))
    with pytest.raises(manifest.ManifestError):
        manifest.resolve("throwaway-cell", small_root)
