"""ctypes binding of the native host preprocessing library (`preprocess.cpp`).

The library is compiled at first use with `g++ -O3 -fPIC -shared -std=c++17
-pthread` (the compiler named by `$CXX` when it is set) into
`build/s2m2_torch/libs2m2_preprocess.so` at the repository root, and
recompiled when the source is newer than it; each compile counts under
`kernels.built`, and the first load is the span `kernels.load`
(runtime/trace.py). A failed build raises: there is no numpy fallback in
here. The plain numpy versions are
`utils.image.remap_plain` and `utils.image.image_pad_plain`, which the tests
hold this library against. Several processes may build at once (pytest-xdist
workers): each takes an exclusive lock on a file beside the library,
compiles into a temporary file and renames it into place.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from ..runtime import trace

SOURCE = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "s2m2_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    return BUILD_DIR / "libs2m2_preprocess.so"


def build() -> float:
    """Compile preprocess.cpp unless the library is at least as new as the
    source; returns the wall seconds taken (waiting for another process's
    build included). Raises RuntimeError when the compiler is missing or
    fails."""
    t0 = time.perf_counter()
    _compile()
    return time.perf_counter() - t0


def _compile() -> bool:
    """build()'s work; True when it compiled the library."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libs2m2_preprocess.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime:
            return False
        cxx = os.environ.get("CXX") or "g++"
        if shutil.which(cxx) is None:
            raise RuntimeError(f"C++ compiler {cxx!r} not found: the native preprocessing "
                               f"library is built from {SOURCE} at first use")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{res.stdout}{res.stderr}")
            os.replace(tmp, out)
            trace.count("kernels.built")
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return True


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            with trace.span("kernels.load", library="s2m2_preprocess") as s:
                s.set(built=_compile())
                lib = ctypes.CDLL(str(library_path()))
            trace.count("kernels.loaded")
            f32p = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32 = ctypes.c_int
            lib.remap_bilinear_u8.argtypes = [u8p, i32, i32, i32, f32p, f32p, i32, i32, u8p]
            lib.remap_bilinear_u8.restype = None
            lib.image_pad_blur_f32.argtypes = [f32p, i32, i32, i32, i32, f32p, f32p]
            lib.image_pad_blur_f32.restype = None
            _lib = lib
        return _lib


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def remap_bilinear(img, map_x, map_y):
    """cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0) of a uint8 image: (h, w[, c])
    uint8 and (h_out, w_out) float32 maps -> (h_out, w_out[, c]) uint8,
    rounded to nearest."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"remap_bilinear takes uint8 images, got {img.dtype}")
    gray = img.ndim == 2
    if gray:
        img = img[..., None]
    map_x = np.ascontiguousarray(map_x, np.float32)
    map_y = np.ascontiguousarray(map_y, np.float32)
    if map_x.shape != map_y.shape or map_x.ndim != 2:
        raise ValueError(f"maps must be two (h, w) arrays, got {map_x.shape} and {map_y.shape}")
    h, w, c = img.shape
    ho, wo = map_x.shape
    out = np.empty((ho, wo, c), np.uint8)
    _load().remap_bilinear_u8(_ptr(img, ctypes.c_uint8), h, w, c,
                              _ptr(map_x, ctypes.c_float), _ptr(map_y, ctypes.c_float),
                              ho, wo, _ptr(out, ctypes.c_uint8))
    return out[..., 0] if gray else out


def image_pad(img, factor=32):
    """Blurred-fill pad of one (h, w, c) frame to multiples of `factor`:
    (h_new, w_new, c) float32 (the semantics of utils.image.image_pad_plain)."""
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    h_new = -(-h // factor) * factor
    w_new = -(-w // factor) * factor
    out = np.empty((h_new, w_new, c), np.float32)
    scratch = np.empty((max(h // factor, 1), max(w // factor, 1), c), np.float32)
    _load().image_pad_blur_f32(_ptr(img, ctypes.c_float), h, w, c, factor,
                               _ptr(out, ctypes.c_float), _ptr(scratch, ctypes.c_float))
    return out
