"""Build and load the hand-written CUDA kernels of `stereo_orb_slam_torch/csrc`.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes`. A library's file
name carries a hash of its source and flags, so an edited source is rebuilt
and an unchanged one is reused. Builds run at first use, one `nvcc` process
per source, all started together. Nothing here runs at import.
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

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = ("hamming_top2", "extract_patches", "orb_describe", "orb_describe_oriented",
                  "triangulate_dlt", "detect_corners")

_lock = threading.Lock()
_libs: dict = {}
_functions: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _source(name: str, source=None) -> Path:
    return Path(source) if source is not None else CSRC_DIR / f"{name}.cu"


def library_path(name: str, source=None) -> Path:
    """The library of `csrc/<name>.cu`, or of `source`, another file with
    the same C interface (an earlier design of the kernel, say)."""
    src = _source(name, source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names=KERNEL_SOURCES, source=None) -> float:
    """Compile the libraries of `names` that are not built yet, in parallel
    (with `source`, one name, built from that file).

    Returns the wall seconds spent; raises with nvcc's output on failure.
    The compiler's register and spill report goes to `<library>.log`.
    """
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if not library_path(n, source).exists()]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name in todo:
            out = library_path(name, source)
            tmp = out.with_suffix(".tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_source(name, source))]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str, source=None) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` (or of `source`), built first
    if needed."""
    key = (name, source)
    lib = _libs.get(key)
    if lib is None:
        build((name,), source)
        with _lock:
            lib = _libs.get(key)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name, source)))
                _libs[key] = lib
    return lib


def function(name: str, symbol: str, argtypes, source=None):
    """`symbol` of the library of `csrc/<name>.cu` (or of `source`),
    returning a C int, with its `argtypes` and `restype` set once, at first
    use, and not per call."""
    fn = _functions.get((name, symbol, source))
    if fn is None:
        fn = getattr(load(name, source), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[(name, symbol, source)] = fn
    return fn
