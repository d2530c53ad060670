"""ctypes bindings for the native IO runtime (native/sift_io.cpp).

Equivalent capability to the reference's C++ host layer (HostImage +
OpenCV ingestion + pinned staging): dependency-free PGM/PPM decode,
RGB->gray conversion, and a multithreaded prefetching frame queue that
overlaps disk IO/decode with device compute.  Builds on demand with make;
falls back to the cv2 path in sift_jax.io.image when unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsift_io.so")

_lib = None


def _stale() -> bool:
    """True when the built .so predates the current source (a stale
    library called through a newer ctypes signature corrupts memory)."""
    try:
        src = os.path.join(_NATIVE_DIR, "sift_io.cpp")
        return os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    except OSError:
        return False


def _load(build: bool = True):
    global _lib
    if _lib is not None:
        return _lib
    if build and (not os.path.exists(_LIB_PATH) or _stale()):
        try:
            subprocess.run(["make", "-B", "-C", _NATIVE_DIR], check=True,
                           capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        # Versioned symbol: raises AttributeError on a stale pre-capacity
        # build, turning silent memory corruption into a clean fallback.
        lib.sift_io_loader_next_v2
    except (OSError, AttributeError):
        return None
    lib.sift_io_read_pnm.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.sift_io_read_pnm.restype = ctypes.c_int
    lib.sift_io_read_into.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
    lib.sift_io_read_into.restype = ctypes.c_int
    lib.sift_io_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.sift_io_loader_create.restype = ctypes.c_void_p
    lib.sift_io_loader_next_v2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.sift_io_loader_next_v2.restype = ctypes.c_int
    lib.sift_io_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.sift_io_rgb8_to_gray.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def read_pnm(path: str) -> np.ndarray:
    """Decode a PGM/PPM file to float32 grayscale [H, W] (0..255)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native sift_io library unavailable")
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.sift_io_read_pnm(path.encode(), ctypes.byref(w),
                            ctypes.byref(h)) != 0:
        raise IOError(f"cannot decode PNM: {path}")
    out = np.empty((h.value, w.value), np.float32)
    if lib.sift_io_read_into(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            w.value, h.value) != 0:
        raise IOError("decode size mismatch")
    return out


def rgb8_to_gray(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 -> [H, W] float32 grayscale (BT.601)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native sift_io library unavailable")
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    out = np.empty((h, w), np.float32)
    lib.sift_io_rgb8_to_gray(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h)
    return out


class FrameLoader:
    """Multithreaded prefetching frame queue over a list of PNM paths.
    Frames are delivered in path order; decode runs ``n_threads`` wide and
    up to ``capacity`` frames ahead (≙ overlapping the reference's host
    image loads with device compute)."""

    def __init__(self, paths: List[str], n_threads: int = 2,
                 capacity: int = 4, out_size: Optional[Tuple[int, int]]
                 = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native sift_io library unavailable")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        ow, oh = out_size if out_size else (0, 0)
        self._max_wh = out_size
        self._handle = lib.sift_io_loader_create(
            arr, len(self._paths), n_threads, capacity, ow, oh)
        self._buf = None

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is None:
            raise StopIteration
        # Buffer sized generously on first use; native API copies w*h.
        if self._buf is None:
            if self._max_wh:
                w, h = self._max_wh
                self._buf = np.empty((h, w), np.float32)
            else:
                self._buf = np.empty((8192 * 8192,), np.float32)
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self._lib.sift_io_loader_next_v2(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._buf.size, ctypes.byref(w), ctypes.byref(h))
        if rc == -2:
            self.close()
            raise StopIteration
        if rc == -3:
            raise IOError(
                f"frame {w.value}x{h.value} exceeds loader buffer "
                f"({self._buf.size} floats); pass out_size= to bound frames")
        if rc != 0:
            raise IOError("frame decode failed")
        return self._buf.reshape(-1)[: w.value * h.value] \
            .reshape(h.value, w.value).copy()

    def close(self):
        if self._handle is not None:
            self._lib.sift_io_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
