"""Scanline (row-batched) attention: kernels A and B.

Every image row is an independent sequence, so q, k, v are (B, N, D) with
B = batch x heads x rows folded together. On a CUDA tensor the wrappers
launch the hand-written kernel of `csrc/scanline_attention.cu`; on a CPU
tensor they run the plain version beside it. A call on the card that
autograd records (grad enabled, an input requiring grad) goes through
`ScanlineAttention` / `ScanlineCrossAttention`, whose backward recomputes
the plain version (ops/_grad.py); serving keeps the direct launch. While
torch.export traces, and on meta tensors, the wrappers call the custom ops
`s2m2_torch::scanline_attention` / `scanline_cross_attention_packed`
(ops/library.py) instead, whose CUDA kernels are the same launches.
Numerics follow `s2m2_tpu/ops/flash_attention.py`: float32 scores scaled
after the dot, float32 softmax, probabilities rounded to v's dtype
before PV, PV accumulated in float32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from ._grad import plain_vjp, wants_grad

MAX_HEAD_DIM = 384
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {torch.float32: "split TF32", torch.bfloat16: "tensor core bf16"}
# padded D -> (warps per block, 16-query m-tiles per warp, warps per query
# slice, keys per tile, K/V stages, blocks per SM the registers are capped
# for): the one table of instances. The build compiles exactly these into
# csrc/scanline_attention.cu's `dispatch_*` (through `instances_header`)
_INSTANCES = {
    torch.float32: {8: (4, 1, 1, 64, 2, 4), 16: (4, 1, 1, 64, 2, 2),
                    32: (4, 1, 1, 64, 2, 2), 48: (4, 1, 1, 32, 2, 4),
                    64: (4, 1, 1, 32, 2, 3), 96: (4, 1, 1, 32, 2, 2),
                    128: (4, 1, 1, 32, 2, 2), 192: (16, 1, 4, 32, 2, 1),
                    256: (8, 2, 4, 32, 2, 1), 384: (8, 2, 4, 16, 2, 1)},
    torch.bfloat16: {16: (4, 1, 1, 64, 2, 2), 32: (4, 1, 1, 64, 2, 2),
                     48: (4, 1, 1, 64, 2, 2), 64: (4, 1, 1, 32, 2, 4),
                     96: (4, 1, 1, 64, 2, 2), 128: (4, 1, 1, 32, 2, 4),
                     192: (4, 1, 1, 32, 3, 2), 256: (4, 1, 1, 32, 2, 1),
                     384: (8, 1, 2, 32, 3, 1)},
}


class Plan(NamedTuple):
    """The kernel instance for one (dtype, D): its path, padded head dim,
    queries per block, shared-memory bytes, warps per block, 16-query
    m-tiles per warp, warps per query slice (each with its share of the
    columns and of the dot), keys per K/V tile, tiles in flight and blocks
    per SM."""
    path: str
    dp: int
    bq: int
    smem: int
    warps: int
    mt: int
    wn: int
    bk: int
    stages: int
    minb: int


def _instance_smem(dtype, dp, warps, mt, wn, bk, stages):
    """Shared bytes of one block: the Q tile and `stages` (K, V) tiles, rows
    padded by 16 bytes, and with wn > 1 each warp's float32 16*mt x bk
    partial scores."""
    bq = 16 * mt * warps // wn
    return ((bq + 2 * stages * bk) * (dp * dtype.itemsize + 16)
            + (warps * mt * 16 * bk * 4 if wn > 1 else 0))


@functools.lru_cache(maxsize=None)
def plan(dtype, d) -> Plan:
    """The instance that runs head dim `d` in `dtype`: D padded to the
    smallest compiled DP >= d (zero columns in shared memory)."""
    table = _INSTANCES.get(dtype)
    if table is None:
        raise TypeError(f"dtype {dtype} not supported (float32 or bfloat16)")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    dp = min(p for p in table if p >= d)
    warps, mt, wn, bk, stages, minb = table[dp]
    return Plan(_PATHS[dtype], dp, 16 * mt * warps // wn,
                _instance_smem(dtype, dp, warps, mt, wn, bk, stages), warps, mt, wn, bk,
                stages, minb)


def instances_header() -> str:
    """The C header csrc/scanline_attention.cu includes from the build
    directory: `_INSTANCES` as two X-macro lists, X(DP, warps, m-tiles, WN,
    BK, stages, blocks per SM) for each compiled instance."""
    lines = ["// Generated from _INSTANCES in s2m2_torch/ops/flash_attention.py."]
    for macro, dtype in (("S2M2_TF32_INSTANCES", torch.float32),
                         ("S2M2_BF16_INSTANCES", torch.bfloat16)):
        cases = " ".join(f"X({', '.join(map(str, (dp, *inst)))})"
                         for dp, inst in sorted(_INSTANCES[dtype].items()))
        lines.append(f"#define {macro}(X) {cases}")
    return "\n".join(lines) + "\n"


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
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")


def _check_packed(tensors):
    _check(tensors)
    if tensors[0].shape[0] % 2:
        raise ValueError(f"packed cross attention needs an even batch, "
                         f"got {tensors[0].shape[0]}")


def _entry():
    """The C entry point, its signature set once when the library loads."""
    return _build.entry("scanline_attention", "s2m2_scanline_attention",
                        (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 8)


def _launch(name, dirs, inputs, b, n, d):
    """Run the CUDA kernel: `dirs` holds, for one (self) or two (cross)
    directions, the (q, k, v) data pointers of contiguous (b, n, d)
    operands inside the tensors `inputs`. Returns one (ndir*b, n, d)
    tensor, direction i's output in rows [i*b, (i+1)*b)."""
    q = inputs[0]
    p = plan(q.dtype, d)
    if not 1 <= b <= 65535 or n < 1:
        raise ValueError(f"{name}: unsupported shape {(b, n, d)}")
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError(f"{name}: inputs must be contiguous")
    out = torch.empty((len(dirs) * b, n, d), dtype=q.dtype, device=q.device)
    step = b * n * d * q.element_size()
    ptrs = [x for i, qkv in enumerate(dirs) for x in (*qkv, out.data_ptr() + i * step)]
    if len(dirs) == 1:
        ptrs += ptrs
    _build.call(_entry(), q.device, name, *ptrs, b, n, d, _DTYPES[q.dtype], p.dp, p.bq,
                p.smem, len(dirs))
    return out


def _attention_kernel(q, k, v):
    """Kernel A's direct launch on contiguous CUDA tensors (no gradient)."""
    return _launch("scanline_attention", [(q.data_ptr(), k.data_ptr(), v.data_ptr())],
                   (q, k, v), *q.shape)


def _cross_kernel(q, k, v):
    """Kernel B's direct launch on the packed (2B, N, D) batch (no gradient)."""
    b2, n, d = q.shape
    b = b2 // 2
    half = b * n * d * q.element_size()  # view y's offset, in bytes
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    return _launch("scanline_cross_attention", [(qp, kp + half, vp + half), (qp + half, kp, vp)],
                   (q, k, v), b, n, d)


def packed_cross_attention_plain(q, k, v):
    """Kernel B's plain version on the packed (x | y) batch: (2B, N, D) in,
    attn(qx, ky, vy) then attn(qy, kx, vx) out."""
    b = q.shape[0] // 2
    return torch.cat(scanline_cross_attention_plain(q[:b], k[:b], v[:b],
                                                    q[b:], k[b:], v[b:]))


class ScanlineAttention(torch.autograd.Function):
    """Kernel A with a gradient: the forward launches the kernel, the
    backward is the vector-Jacobian product of `scanline_attention_plain`
    recomputed from the saved inputs (ops/_grad.py)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _attention_kernel(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(scanline_attention_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, (grad,))


class ScanlineCrossAttention(torch.autograd.Function):
    """Kernel B (packed) with a gradient, as `ScanlineAttention`."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _cross_kernel(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(packed_cross_attention_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, (grad,))


def scanline_attention(q, k, v):
    """Row-batched attention: q, k, v (B, N, D) -> (B, N, D). On the card a
    call that autograd records goes through `ScanlineAttention`."""
    _check((q, k, v))
    if _build.via_op(q):
        return _build.op("scanline_attention")(q, k, v)
    if q.device.type == "cpu":
        return scanline_attention_plain(q, k, v)
    if wants_grad(q, k, v):
        return ScanlineAttention.apply(q, k, v)
    return _attention_kernel(q, k, v)


def scanline_cross_attention(qx, kx, vx, qy, ky, vy):
    """Symmetric cross-view attention: returns (attn(qx, ky, vy), attn(qy,
    kx, vx)); all six inputs (B, N, D). On the card the views are packed
    and run through `scanline_cross_attention_packed`, the model's form."""
    _check((qx, kx, vx, qy, ky, vy))
    if qx.device.type == "cpu" and not _build.via_op(qx):
        return scanline_cross_attention_plain(qx, kx, vx, qy, ky, vy)
    out = scanline_cross_attention_packed(torch.cat((qx, qy)), torch.cat((kx, ky)),
                                          torch.cat((vx, vy)))
    b = qx.shape[0]
    return out[:b], out[b:]


def scanline_cross_attention_packed(q, k, v):
    """`scanline_cross_attention` on the packed (x | y) batch: q, k, v are
    (2B, N, D) with view x in rows [0, B); returns (2B, N, D), attn(qx, ky,
    vy) then attn(qy, kx, vx), written by the kernel into one tensor. On the
    card a call that autograd records goes through `ScanlineCrossAttention`."""
    _check_packed((q, k, v))
    if _build.via_op(q):
        return _build.op("scanline_cross_attention_packed")(q, k, v)
    if q.device.type == "cpu":
        return packed_cross_attention_plain(q, k, v)
    if wants_grad(q, k, v):
        return ScanlineCrossAttention.apply(q, k, v)
    return _cross_kernel(q, k, v)
