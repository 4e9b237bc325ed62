"""The check for JAX in a process compares top-level module names whole:
the port's name begins with the JAX package's."""

import sys
import types

from harness import launcher


def test_whole_top_level_names(monkeypatch):
    for name in ("omero_ms_pixel_buffer_tpu", "jax", "jaxlib", "flax"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "omero_ms_pixel_buffer_tpu_torch_x", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    assert launcher.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "omero_ms_pixel_buffer_tpu.ops", types.ModuleType("o"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("j"))
    assert launcher.forbidden_modules() == ["jax", "omero_ms_pixel_buffer_tpu"]


def test_harness_imports_no_jax():
    import subprocess

    from conftest import BENCH

    code = ("import sys; sys.path.insert(0, %r); "
            "import harness.cell, harness.trace, reference.png, reference.composite; "
            "from harness.launcher import forbidden_modules; "
            "assert forbidden_modules() == [], forbidden_modules()") % str(BENCH)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
