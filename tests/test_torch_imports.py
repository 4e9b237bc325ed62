"""Import boundary of the port: it and ``chip_smoke.py`` import no ``jax``
and nothing of the JAX package, and its entry points default to CUDA
and raise without a GPU unless given ``device="cpu"``."""

import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from omero_ms_pixel_buffer_tpu_torch.io.pixels_service import ImageRegistry, PixelsService
from omero_ms_pixel_buffer_tpu_torch.models.tile_pipeline import TilePipeline

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "omero_ms_pixel_buffer_tpu_torch"

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises
import omero_ms_pixel_buffer_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = [m for m in sys.modules
       if m == "jax" and sys.modules[m] is not None
       or m.split(".")[0] == "omero_ms_pixel_buffer_tpu"]
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top != "jax", f"{path}: imports {name}"
            assert top != "omero_ms_pixel_buffer_tpu", f"{path}: imports {name}"


def test_pipeline_defaults_to_cuda_and_never_falls_back(tmp_path):
    assert inspect.signature(TilePipeline).parameters["device"].default == "cuda"
    service = PixelsService(ImageRegistry())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TilePipeline(service)
    pipe = TilePipeline(service, device="cpu")
    try:
        assert pipe.device.type == "cpu"
    finally:
        pipe.close()
