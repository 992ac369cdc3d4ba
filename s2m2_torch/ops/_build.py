"""Build and load the hand-written CUDA kernels of `s2m2_torch/csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC` into `build/s2m2_torch/lib<name>.so` at the repository root, then
loaded with ctypes. A library is rebuilt when its source is newer. Nothing
here runs at import time: the CPU tests import every module of the package
on machines with no `nvcc` and no card.

Every kernel wrapper adds one to its entry of `launch_counts` each time it
launches its kernel, and nowhere else, so a run can show which kernels its
path went through.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "s2m2_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts = {"scanline_attention": 0, "scanline_cross_attention": 0,
                 "fused_correlation_ot": 0, "fused_basic_attn_block": 0,
                 "int8_quantize_pack": 0, "int8_gemm": 0, "bf16_gemm": 0}

_libs: dict = {}
_lock = threading.Lock()


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the s2m2_torch CUDA kernels are built "
                       "with the CUDA toolkit's nvcc on first use")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _start_build(name: str):
    """Start nvcc for csrc/<name>.cu; returns (process, tmp .so, log path),
    or None when the library is already up to date."""
    src = CSRC / f"{name}.cu"
    out = _lib_path(name)
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = BUILD_DIR / f"{name}.log"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, log


def _finish_build(name: str, started):
    proc, tmp, log = started
    text, _ = proc.communicate()
    log.write_text(text)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{text}")
    os.replace(tmp, _lib_path(name))


def build_all() -> float:
    """Compile every csrc/*.cu that is out of date, one nvcc each, all
    started together. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    errors = []
    with _lock:
        started = {n: _start_build(n) for n in names}
        for n, s in started.items():
            if s is None:
                continue
            try:  # wait for every nvcc before raising: no process outlives this
                _finish_build(n, s)
            except RuntimeError as err:
                errors.append(str(err))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start_build(name)
            if started is not None:
                _finish_build(name, started)
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        lib.s2m2_error_string.restype = ctypes.c_char_p
        lib.s2m2_error_string.argtypes = [ctypes.c_int]
        msg = lib.s2m2_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
