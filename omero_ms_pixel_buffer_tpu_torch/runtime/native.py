"""ctypes loader for the native C++ host engine (counterpart of
``omero_ms_pixel_buffer_tpu/runtime/native.py``, bound as far as the
port's host routes need it: the fused PNG encode of whole tiles, the
deflate and framing of scanlines the device filtered, the batched TIFF
block decode (zlib, LZW, PackBits) and the JPEG entropy-scan walker).

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
    """The C API's fused PNG encode and PNG assembly, batched block decode
    and JPEG scan walker, its version and its pool size. Thread-safe (the
    C side has its own pool)."""

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
        # ABI v3 added the per-block codec dispatch (zlib/LZW/PackBits)
        self.has_decode_batch = self.version >= 3 and hasattr(lib, "ompb_decode_batch")
        if self.has_decode_batch:
            lib.ompb_decode_batch.restype = ctypes.c_int
        # ABI v4 added the JPEG entropy-scan walker
        self.has_jpeg_scan = self.version >= 4 and hasattr(lib, "ompb_jpeg_scan")
        if self.has_jpeg_scan:
            lib.ompb_jpeg_scan.restype = ctypes.c_int
        self.pool_size = lib.ompb_pool_size()

    @staticmethod
    def _in_arrays(buffers: Sequence[bytes]):
        """Pointer and length arrays over immutable bytes objects (no
        copy); ``keep`` pins the objects and their views for the call."""
        n = len(buffers)
        ins = (_U8P * n)()
        lens = (ctypes.c_size_t * n)()
        keep = []
        for i, b in enumerate(buffers):
            view = ctypes.c_char_p(b)
            keep.append((b, view))
            ins[i] = ctypes.cast(view, _U8P)
            lens[i] = len(b)
        return ins, lens, keep

    def decode_batch(
        self, buffers: Sequence[bytes], out_sizes: Sequence[int], codecs: Sequence[int],
    ) -> List[Optional[np.ndarray]]:
        """Decode N TIFF blocks with per-block codec dispatch (8 = zlib,
        5 = LZW, 32773 = PackBits) into fresh uint8 arrays of the given
        capacities, in one GIL-released call on the native pool; None per
        failed block. Needs ABI v3 (``has_decode_batch``): the reader
        decodes in Python without it."""
        if not self.has_decode_batch:
            raise RuntimeError(f"native library ABI v{self.version} has no ompb_decode_batch")
        n = len(buffers)
        if n == 0:
            return []
        ins, lens, _keep = self._in_arrays(buffers)
        outs = (_U8P * n)()
        out_lens = (ctypes.c_size_t * n)()
        codec_arr = (ctypes.c_int * n)(*[int(c) for c in codecs])
        arrays = []
        for i, size in enumerate(out_sizes):
            arr = np.empty(int(size), dtype=np.uint8)
            arrays.append(arr)
            outs[i] = arr.ctypes.data_as(_U8P)
            out_lens[i] = int(size)
        rc = self._lib.ompb_decode_batch(ctypes.c_int(n), ins, lens, codec_arr, outs, out_lens)
        return [None if rc and out_lens[i] == 0 else arr[: out_lens[i]]
                for i, arr in enumerate(arrays)]

    def jpeg_scan(
        self, scan: bytes, seg_offsets: Sequence[int], seg_mcu_ranges: Sequence[tuple],
        mcux: int, comp_h: Sequence[int], comp_v: Sequence[int], comp_bw: Sequence[int],
        dc_luts: Sequence[tuple], ac_luts: Sequence[tuple], out_blocks: Sequence[np.ndarray],
    ) -> int:
        """Baseline JPEG entropy scan (``io/jpeg``'s byte-serial half) over
        destuffed restart segments; fills the caller's zeroed int32
        (nblocks, 64) coefficient arrays in natural order. LUTs are the
        16-bit-peek (sym, nbits) pairs ``io/jpeg`` builds. Returns the C
        error code (0 = ok; -100 without the ABI v4 symbol); the GIL is
        released for the walk."""
        if not self.has_jpeg_scan:
            return -100
        ncomp = len(comp_h)
        n_segs = len(seg_offsets)
        offs = (ctypes.c_int64 * n_segs)(*seg_offsets)
        m0 = (ctypes.c_int32 * n_segs)(*[a for a, _ in seg_mcu_ranges])
        m1 = (ctypes.c_int32 * n_segs)(*[b for _, b in seg_mcu_ranges])
        ch = (ctypes.c_int32 * ncomp)(*comp_h)
        cv = (ctypes.c_int32 * ncomp)(*comp_v)
        cbw = (ctypes.c_int32 * ncomp)(*comp_bw)

        def lut_ptrs(luts, idx):
            arr = (_U8P * ncomp)()
            for i, pair in enumerate(luts):
                arr[i] = pair[idx].ctypes.data_as(_U8P)
            return arr

        i32p = ctypes.POINTER(ctypes.c_int32)
        outs = (i32p * ncomp)()
        for i, blocks in enumerate(out_blocks):
            if blocks.dtype != np.int32 or not blocks.flags["C_CONTIGUOUS"]:
                # wrong strides would let C write past the array
                raise ValueError("jpeg_scan out_blocks must be C-contiguous int32")
            outs[i] = blocks.ctypes.data_as(i32p)
        return self._lib.ompb_jpeg_scan(
            scan, ctypes.c_size_t(len(scan)), offs, ctypes.c_int(n_segs), m0, m1,
            ctypes.c_int(mcux), ctypes.c_int(ncomp), ch, cv, cbw,
            lut_ptrs(dc_luts, 0), lut_ptrs(dc_luts, 1),
            lut_ptrs(ac_luts, 0), lut_ptrs(ac_luts, 1), outs,
        )

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
        ins, lens, _keep = self._in_arrays(filtered)
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
