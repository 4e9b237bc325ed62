"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and bind them
through ``ctypes``.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), named by a
hash of the source and flags under ``build/torch_kernels/`` at the root
of the checkout. ``build()`` starts one ``nvcc`` per missing library,
all at once, and waits for them; ``library(name)`` builds on first use
and loads. Pointers and the stream cross as ``c_void_p``; every C entry
returns ``cudaGetLastError()`` and ``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = {"filter": "filter.cu", "bitpack": "bitpack.cu", "bitpack_dense": "bitpack_dense.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, object] = {}


class KernelError(RuntimeError):
    """A kernel failed to build or launch."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError("nvcc not found: the CUDA toolkit is required")


def target(name: str) -> Path:
    """Library path for one kernel: keyed by its source and flags."""
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns {name: {"seconds",
    "log"}} for what was compiled (ptxas register/spill report in
    ``log``); raises ``KernelError`` with the compiler output on any
    failure."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = target(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, out, time.perf_counter(),
        )
    report: Dict[str, dict] = {}
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failures:
        raise KernelError("kernel build failed:\n" + "\n".join(failures))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(target(name)))
            _libs[name] = lib
        return lib


def entry(name: str, symbol: str, argtypes: list):
    """One C entry of a kernel library, typed once: every argument
    declared (pointers as ``c_void_p``), returning the CUDA error code."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        raise KernelError(f"{what}: CUDA error {code}")


def stream_handle(device) -> ctypes.c_void_p:
    """The current PyTorch stream of ``device`` as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
