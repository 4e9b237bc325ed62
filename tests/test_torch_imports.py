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


VIEWER_PLANE_MODULES = ["http.protocols", "http.protocols.dzi", "http.protocols.iiif",
            "http.protocols.iris", "resilience.admission", "resilience.scheduler",
            "resilience.faultinject", "resilience.deadline", "utils.loop_watchdog"]


@pytest.mark.parametrize("name", VIEWER_PLANE_MODULES)
def test_viewer_plane_modules_are_in_the_port(name):
    """The viewer plane's modules exist under their JAX paths and sit in the
    walk the no-jax probe imports."""
    path = PORT.joinpath(*name.split("."))
    assert path.with_suffix(".py").is_file() or (path / "__init__.py").is_file(), name
    assert path.with_suffix(".py") in _sources() or path / "__init__.py" in _sources()


OBSERVABILITY_PLANE_MODULES = ["utils.metrics", "obs", "obs.recorder", "obs.sli",
                               "utils.process_metrics", "utils.tracing",
                               "cache.plane.tinylfu", "cache.prefetch"]


@pytest.mark.parametrize("name", OBSERVABILITY_PLANE_MODULES)
def test_observability_and_cache_plane_modules_are_in_the_port(name):
    """The default-on planes' modules (metrics, flight recorder, SLI,
    process collector, tracing, TinyLFU, prefetcher) exist under their JAX
    paths and sit in the walk the no-jax probe imports."""
    path = PORT.joinpath(*name.split("."))
    assert path.with_suffix(".py").is_file() or (path / "__init__.py").is_file(), name
    assert path.with_suffix(".py") in _sources() or path / "__init__.py" in _sources()


FLEET_PLANE_MODULES = ["cache.plane.ring", "cache.plane.l2", "cache.plane.peer",
                       "cache.plane.coordinator", "cluster", "cluster.security",
                       "cluster.integrity", "cluster.epochs", "cluster.link",
                       "cluster.replicate", "cluster.repair", "cluster.hedge", "cluster.suspect",
                       "cluster.lifecycle", "cluster.membership", "cluster.gossip",
                       "cluster.brains", "http.target"]


@pytest.mark.parametrize("name", FLEET_PLANE_MODULES)
def test_fleet_plane_modules_are_in_the_port(name):
    """The fleet's modules (ring, L2, peer client, coordinator, the
    cluster package with dynamic membership, gossip and the brains, and
    the front's request-target rules) exist under their JAX paths (the
    port's own ``http/target.py`` beside them) and sit in the walk the
    no-jax probe imports."""
    path = PORT.joinpath(*name.split("."))
    assert path.with_suffix(".py").is_file() or (path / "__init__.py").is_file(), name
    assert path.with_suffix(".py") in _sources() or path / "__init__.py" in _sources()


WRITE_AND_MESH_PLANE_MODULES = ["ingest", "ingest.assembler", "parallel", "parallel.mesh",
                                "parallel.sharding"]


@pytest.mark.parametrize("name", WRITE_AND_MESH_PLANE_MODULES)
def test_write_and_mesh_plane_modules_are_in_the_port(name):
    """The ingest plane's and the multi-device plane's modules exist under
    their JAX paths and sit in the walk the no-jax probe imports."""
    path = PORT.joinpath(*name.split("."))
    assert path.with_suffix(".py").is_file() or (path / "__init__.py").is_file(), name
    assert path.with_suffix(".py") in _sources() or path / "__init__.py" in _sources()


def test_mesh_entry_points_default_to_cuda():
    """``make_mesh`` with no devices takes the visible CUDA devices (none
    on a host without one: ``"auto"`` then builds no mesh)."""
    from omero_ms_pixel_buffer_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError, match="slot"):
            make_mesh()
    else:
        assert all(d.type == "cuda" for d in make_mesh().devices)


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
