"""ctypes binding for the native libpng decoder (native/png_loader.cpp).

A copy of the JAX package's `io/native_image.py`; it loads the repository's
`native/` library, which belongs to neither package.

Builds the shared library on first import if missing (g++ is part of the
baked toolchain); every entry point degrades to None so callers can fall
back to PIL.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsosl_native.so")

_lib = None
_lock = threading.Lock()


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR],
                    check=True, capture_output=True, timeout=120,
                )
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.png_gray_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.png_gray_read.restype = ctypes.c_int
        lib.png_gray_dims.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.png_gray_dims.restype = ctypes.c_int
        _lib = lib
        return _lib


def read_png_gray(path: str):
    """[H, W] float32 grayscale (0..255), or None on failure."""
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.png_gray_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    out = np.empty((h.value, w.value), np.float32)
    rc = lib.png_gray_read(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size,
        ctypes.byref(h),
        ctypes.byref(w),
    )
    if rc != 0:
        return None
    return out
