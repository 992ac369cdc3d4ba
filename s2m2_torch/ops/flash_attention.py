"""Scanline (row-batched) attention: kernels A and B.

Every image row is an independent sequence, so q, k, v are (B, N, D) with
B = batch x heads x rows folded together. On a CUDA tensor the wrappers
launch the hand-written kernel of `csrc/scanline_attention.cu`; on a CPU
tensor they run the plain version beside it. Numerics follow
`s2m2_tpu/ops/flash_attention.py`: float32 scores scaled after the dot,
float32 softmax, probabilities rounded to v's dtype before PV, PV
accumulated in float32.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_HEAD_DIM = 384
# output-accumulator widths (D <= 16 * NC) the scalar kernel of
# csrc/scanline_attention.cu is instantiated for
_NC_BUCKETS = (1, 2, 4, 8, 12, 16, 24)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def scanline_attention_plain(q, k, v):
    """softmax(q k^T * D^-1/2) v for (B, N, D) inputs, as the TPU kernel's
    `_row_attn_kernel` computes it."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def scanline_cross_attention_plain(qx, kx, vx, qy, ky, vy):
    return (scanline_attention_plain(qx, ky, vy),
            scanline_attention_plain(qy, kx, vx))


def _check(tensors):
    q = tensors[0]
    if q.dim() != 3:
        raise ValueError(f"attention inputs must be (B, N, D), got {tuple(q.shape)}")
    for t in tensors:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("attention inputs must share shape, dtype and device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _launch(dirs, name):
    """Run the CUDA kernel for one (self) or two (cross) directions, each a
    (q, k, v) triple of contiguous (B, N, D) tensors; returns the outputs."""
    q = dirs[0][0]
    b, n, d = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if not 1 <= b <= 65535 or n < 1:
        raise ValueError(f"{name}: unsupported shape {tuple(q.shape)}")
    for t in (x for triple in dirs for x in triple):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    nc = next(c for c in _NC_BUCKETS if 16 * c >= d)
    outs = [torch.empty_like(q) for _ in dirs]
    ptrs = []
    for (qq, kk, vv), o in zip(dirs, outs):
        ptrs += [qq.data_ptr(), kk.data_ptr(), vv.data_ptr(), o.data_ptr()]
    if len(dirs) == 1:
        ptrs += ptrs
    lib = _build.library("scanline_attention")
    fn = lib.s2m2_scanline_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, b, n, d, nc, _DTYPES[q.dtype], len(dirs), stream)
    _build.check(lib, err, name)
    _build.launch_counts[name] += 1
    return outs


def scanline_attention(q, k, v):
    """Row-batched attention: q, k, v (B, N, D) -> (B, N, D)."""
    _check((q, k, v))
    if q.device.type == "cpu":
        return scanline_attention_plain(q, k, v)
    return _launch([(q, k, v)], "scanline_attention")[0]


def scanline_cross_attention(qx, kx, vx, qy, ky, vy):
    """Symmetric cross-view attention in one launch: returns
    (attn(qx, ky, vy), attn(qy, kx, vx)); all six inputs (B, N, D)."""
    _check((qx, kx, vx, qy, ky, vy))
    if qx.device.type == "cpu":
        return scanline_cross_attention_plain(qx, kx, vx, qy, ky, vy)
    ox, oy = _launch([(qx, ky, vy), (qy, kx, vx)], "scanline_cross_attention")
    return ox, oy
