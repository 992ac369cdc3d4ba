"""Build and load the hand-written CUDA kernels of `s2m2_torch/csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC` into `build/s2m2_torch/lib<name>.so` at the repository root, then
loaded with ctypes. A library is rebuilt when its source, a shared header
of `csrc/` (`*.cuh`) that it includes, or a header the build generates for
it from Python (`_generated_headers`), is newer. Nothing
here runs at import time: the CPU tests import every module of the package
on machines with no `nvcc` and no card.

Every kernel wrapper adds one to its entry of `launch_counts` each time it
launches its kernel, and nowhere else, so a run can show which kernels its
path went through; `runtime.trace.counters()` reports them as
`launch.<kernel>`, beside `kernels.built` (each nvcc build) and
`kernels.loaded`. `library`'s first load of each library, its build
included, is the span `kernels.load`. `entry` and `call` are the one way
the wrappers reach a C entry point: the signature is set once, and a
launch passes the raw current stream and switches the device only when it
must.

`via_op` and `op` route a wrapper's call through its registered custom op
(`ops/library.py`) while `torch.export` traces, and for meta tensors: the
ctypes launch is opaque to tracing, the custom op is not.
"""
from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from ..runtime import trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "s2m2_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts = {"scanline_attention": 0, "scanline_cross_attention": 0,
                 "fused_correlation_ot": 0, "fused_basic_attn_block": 0,
                 "int8_quantize_pack": 0, "int8_gemm": 0, "bf16_gemm": 0,
                 "int8_attention": 0}

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


def _generated_headers(name: str) -> dict:
    """{file name: text} of the headers csrc/<name>.cu includes from the
    build directory: kernels A and B compile the instance table of
    ops/flash_attention.py, kernel E's GEMM that of ops/int8_gemm.py,
    kernel D that of ops/fused_block.py and kernel F the wgmma wrappers of
    ops/int8_attention.py, so each table is kept in one place."""
    if name == "scanline_attention":
        from .flash_attention import instances_header
        return {"scanline_attention_instances.h": instances_header()}
    if name == "int8_gemm":
        from .int8_gemm import instances_header
        return {"int8_gemm_instances.h": instances_header()}
    if name == "fused_basic_attn_block":
        from .fused_block import instances_header
        return {"fused_block_instances.h": instances_header()}
    if name == "int8_attention":
        from .int8_attention import instances_header
        return {"int8_attention_instances.h": instances_header()}
    return {}


def _write_generated(name: str) -> float:
    """Write csrc/<name>.cu's generated headers into BUILD_DIR where their
    text changed; returns the newest mtime of the source, the shared
    headers of csrc/ it includes and its generated headers."""
    src = CSRC / f"{name}.cu"
    shared = [CSRC / h for h in re.findall(r'#include "(\w+\.cuh)"', src.read_text())]
    newest = max(p.stat().st_mtime for p in (src, *shared))
    for fname, text in _generated_headers(name).items():
        path = BUILD_DIR / fname
        if not path.exists() or path.read_text() != text:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            path.write_text(text)
        newest = max(newest, path.stat().st_mtime)
    return newest


def _start_build(name: str):
    """Start nvcc for csrc/<name>.cu; returns (process, tmp .so, log path),
    or None when the library is already up to date."""
    src = CSRC / f"{name}.cu"
    out = _lib_path(name)
    newest = _write_generated(name)
    if out.exists() and out.stat().st_mtime >= newest:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = BUILD_DIR / f"{name}.log"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I", str(BUILD_DIR), "-o", tmp, str(src)],
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
    trace.count("kernels.built")


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
            with trace.span("kernels.load", library=name) as s:
                started = _start_build(name)
                s.set(built=started is not None)
                if started is not None:
                    _finish_build(name, started)
                lib = ctypes.CDLL(str(_lib_path(name)))
            trace.count("kernels.loaded")
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        lib.s2m2_error_string.restype = ctypes.c_char_p
        lib.s2m2_error_string.argtypes = [ctypes.c_int]
        msg = lib.s2m2_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


@functools.lru_cache(maxsize=None)
def entry(name: str, symbol: str, argtypes: tuple):
    """(library, C function) of csrc/<name>.cu's `symbol`, its signature set
    once: `argtypes` without the trailing stream, restype int."""
    lib = library(name)
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    return lib, fn


def call(entry_point, device, what, *args):
    """Launch through `entry_point` (from `entry`) on `device`'s current
    stream, raise on a CUDA error, and count the launch under `what`."""
    lib, fn = entry_point
    idx = device.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(idx):
            err = fn(*args, stream)
    check(lib, err, what)
    launch_counts[what] += 1


def via_op(t) -> bool:
    """Whether a wrapper's call on `t` goes through its custom op: while
    torch.export traces (on fake tensors of either device) and for meta
    tensors, which only the ops' fake implementations take."""
    return t.device.type == "meta" or torch.compiler.is_exporting()


def op(name: str):
    """The custom op torch.ops.s2m2_torch.<name>, registered by
    ops/library.py on first use."""
    from . import library  # noqa: F401  (registers the ops)
    return getattr(torch.ops.s2m2_torch, name)
