"""The benchmark's own tests: the harness's folder on the path, and a
throwaway checkout (``small_root``) that holds a copy of the benchmark
with small images and the port's package, for runs on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

SMALL = {"plane-u16-10k": {"size_x": 2100, "size_y": 1600}}
# fewer clients, so that the CPU answers within the server's 15 s budget
FEW = {"tile-png-random": 8, "render-viewport-4x3": 2}


def make_root(tmp: Path) -> Path:
    """A checkout of the benchmark at small image sizes and loads."""
    shutil.copytree(BENCH, tmp / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for name, size in SMALL.items():
        path = tmp / BENCH.name / "configs" / f"{name}.json"
        config = json.loads(path.read_text())
        config["image"].update(size)
        path.write_text(json.dumps(config))
    for name, clients in FEW.items():
        path = tmp / BENCH.name / "traffic" / f"{name}.json"
        mix = json.loads(path.read_text())
        mix["clients"] = clients
        path.write_text(json.dumps(mix))
    for name in ("omero_ms_pixel_buffer_tpu_torch", "native"):
        (tmp / name).symlink_to(ROOT / name)
    return tmp


@pytest.fixture
def small_root(tmp_path):
    return make_root(tmp_path)
