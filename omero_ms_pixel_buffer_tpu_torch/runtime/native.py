"""ctypes loader for the native C++ host encoder (counterpart of
``omero_ms_pixel_buffer_tpu/runtime/native.py``, bound only as far as the
port's host PNG routes need it: the fused encode of whole tiles, and the
deflate and framing of scanlines the device filtered).

The library is ``native/build/libompb_native.so`` at the root of the
checkout, built on first use with ``make -C native`` (g++ and zlib) and
rebuilt when a source is newer than it. ``get_engine()`` is None when it
cannot be built or loaded (or ``OMPB_DISABLE_NATIVE`` is set): callers
then encode with Python zlib, exactly where the JAX package makes the
same choice. ``host_engine()`` names the choice ("native" or "python").
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

log = logging.getLogger("omero_ms_pixel_buffer_tpu_torch.native")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libompb_native.so")
_SOURCES = ("ompb_native.cc", "fast_deflate.cc", "jpeg_scan.cc", "fast_deflate.h")

_U8P = ctypes.POINTER(ctypes.c_uint8)

_PNG_FILTER_CODES = {"none": 0, "sub": 1, "up": 2}

# zlib strategy codes (zlib.h) plus 100 = the in-house RLE + dynamic-
# Huffman encoder (native/fast_deflate.cc), the service default "fast"
ZLIB_STRATEGIES = {
    "default": 0, "filtered": 1, "huffman": 2, "rle": 3, "fixed": 4,
    "fast": 100,
}


def _build_library() -> bool:
    """``make -C native``; False when there are no sources or no toolchain."""
    if not os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
        return False
    try:
        proc = subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.warning("native build unavailable: %s", e)
        return False
    if proc.returncode != 0:
        log.warning("native build failed:\n%s", proc.stderr.decode(errors="replace"))
        return False
    return os.path.exists(_LIB_PATH)


class NativeEngine:
    """The C API's fused PNG encode and PNG assembly, its version and its
    pool size. Thread-safe (the C side has its own pool)."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.ompb_version.restype = ctypes.c_int
        lib.ompb_pool_size.restype = ctypes.c_int
        lib.ompb_free_batch.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        self.version = lib.ompb_version()
        # ABI v2 added the zlib-strategy argument and the fused encode
        # entry point; a stale v1 library has neither
        self._has_fused_encode = self.version >= 2 and hasattr(lib, "ompb_png_encode_batch")
        if self._has_fused_encode:
            lib.ompb_png_encode_batch.restype = ctypes.c_int
        self.pool_size = lib.ompb_pool_size()

    def png_assemble_batch(
        self, filtered: Sequence[bytes], widths: Sequence[int], heights: Sequence[int],
        bit_depths: Sequence[int], color_types: Sequence[int], level: int = 6,
        strategy: str = "rle",
    ) -> List[Optional[bytes]]:
        """N filtered scanline buffers -> N complete PNGs (deflate at
        ``level``/``strategy`` and framing) in one GIL-released native
        call; None per lane that failed."""
        n = len(filtered)
        if n == 0:
            return []
        ins = (_U8P * n)()
        lens = (ctypes.c_size_t * n)()
        keep = []  # the bytes objects the pointers point into
        for i, b in enumerate(filtered):
            view = ctypes.c_char_p(b)
            keep.append((b, view))
            ins[i] = ctypes.cast(view, _U8P)
            lens[i] = len(b)
        outs = (_U8P * n)()
        out_lens = (ctypes.c_size_t * n)()
        args = [
            ctypes.c_int(n), ins, lens,
            (ctypes.c_uint32 * n)(*[int(w) for w in widths]),
            (ctypes.c_uint32 * n)(*[int(h) for h in heights]),
            (ctypes.c_uint8 * n)(*[int(b) for b in bit_depths]),
            (ctypes.c_uint8 * n)(*[int(c) for c in color_types]),
            ctypes.c_int(level),
        ]
        if self.version >= 2:  # the v1 ABI has no strategy argument
            args.append(ctypes.c_int(ZLIB_STRATEGIES.get(strategy, 0)))
        self._lib.ompb_png_assemble_batch(*args, outs, out_lens)
        return self._collect(outs, out_lens, n)

    def _collect(self, outs, out_lens, n: int) -> List[Optional[bytes]]:
        results: List[Optional[bytes]] = []
        try:
            for i in range(n):
                results.append(ctypes.string_at(outs[i], out_lens[i]) if outs[i] else None)
        finally:
            self._lib.ompb_free_batch(ctypes.cast(outs, ctypes.POINTER(ctypes.c_void_p)),
                                      ctypes.c_int(n))
        return results

    def png_encode_batch(
        self, tiles: Sequence[np.ndarray], filter_mode: str = "up", level: int = 6,
        strategy: str = "rle",
    ) -> Optional[List[Optional[bytes]]]:
        """N raw tiles (2-D grayscale or HxWx3 RGB, 8/16-bit) -> N complete
        PNGs in one GIL-released native call (byteswap, filter, deflate,
        framing). None when the library or the inputs are not eligible;
        None per lane that failed."""
        if not self._has_fused_encode or filter_mode not in _PNG_FILTER_CODES:
            return None
        n = len(tiles)
        if n == 0:
            return []
        widths = (ctypes.c_uint32 * n)()
        heights = (ctypes.c_uint32 * n)()
        channels = (ctypes.c_uint8 * n)()
        itemsizes = (ctypes.c_uint8 * n)()
        ins = (_U8P * n)()
        keep = []
        for i, t in enumerate(tiles):
            if t.ndim == 2:
                ch = 1
            elif t.ndim == 3 and t.shape[2] == 3:
                ch = 3
            else:
                return None
            if t.dtype.itemsize not in (1, 2):
                return None
            if t.dtype.byteorder == ">":
                # the C side takes native little-endian input and swaps itself
                t = t.astype(t.dtype.newbyteorder("<"))
            arr = np.ascontiguousarray(t)
            keep.append(arr)
            ins[i] = arr.ctypes.data_as(_U8P)
            heights[i], widths[i] = arr.shape[0], arr.shape[1]
            channels[i], itemsizes[i] = ch, arr.dtype.itemsize
        outs = (_U8P * n)()
        out_lens = (ctypes.c_size_t * n)()
        self._lib.ompb_png_encode_batch(
            ctypes.c_int(n), ins, widths, heights, channels, itemsizes,
            ctypes.c_int(_PNG_FILTER_CODES[filter_mode]), ctypes.c_int(level),
            ctypes.c_int(ZLIB_STRATEGIES.get(strategy, 0)),
            ctypes.c_int(1),  # numpy arrays are native little-endian
            outs, out_lens,
        )
        return self._collect(outs, out_lens, n)


_engine: Optional[NativeEngine] = None
_engine_failed = False
_engine_lock = threading.Lock()


def get_engine() -> Optional[NativeEngine]:
    """The process-wide native engine, built and loaded on first use (and
    rebuilt when stale); None when it cannot be."""
    global _engine, _engine_failed
    if _engine is not None or _engine_failed:
        return _engine
    with _engine_lock:
        if _engine is not None or _engine_failed:
            return _engine
        if os.environ.get("OMPB_DISABLE_NATIVE"):
            _engine_failed = True
            return None
        try:
            if not os.path.exists(_LIB_PATH) and not _build_library():
                _engine_failed = True
                return None
            stale = any(
                os.path.exists(p) and os.path.getmtime(p) > os.path.getmtime(_LIB_PATH)
                for p in (os.path.join(_NATIVE_DIR, f) for f in _SOURCES)
            )
            if stale and not _build_library():
                _engine_failed = True
                return None
            _engine = NativeEngine(ctypes.CDLL(_LIB_PATH))
            log.info("native engine v%d loaded (%d threads)", _engine.version,
                     _engine.pool_size)
        except OSError as e:
            log.warning("native engine unavailable: %s", e)
            _engine_failed = True
    return _engine


def host_engine() -> str:
    """The host PNG encoder lanes larger than every bucket take: "native"
    when the library builds and loads, else "python" (zlib)."""
    return "native" if get_engine() is not None else "python"
