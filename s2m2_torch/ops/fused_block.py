"""Fused scanline BasicAttnBlock: kernel D.

One launch applies a whole BasicAttnBlock (cross attention, FFN, self
attention, FFN, each pre-norm with a residual) to every epipolar row pair
of the two views. On a CUDA tensor the wrapper launches the hand-written
kernel of `csrc/fused_basic_attn_block.cu` (a persistent, warp-specialized
wgmma kernel fed by TMA; float32 by split TF32), with the instance `plan`
chooses from the table `_INSTANCES`; on a CPU tensor it runs the plain
version beside it. Numerics follow the TPU kernel's body
(`s2m2_tpu/ops/fused_block.py:_block_body`), with its rounding points in
the compute dtype; GELU uses the exact erf.

Weights are the 18 tensors of a `models.attention.BasicAttnBlock`, in the
TPU kernel's order and torch's (out, in) Linear layout:
cross q, k, v, v bias, proj; ffn_c w1, b1, w2, b2; self q, k, v, v bias,
proj; ffn w1, b1, w2, b2.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

MAX_DIM = 512  # C and E the kernel takes (s2m2_tpu/models/mrt.py:25)
N_WEIGHTS = 18
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM = 232448  # shared bytes a block may use on the H100
STAGE_BYTES = 128 * 128  # a ring stage: 128 rows x 128 bytes (one weight tile)
MAX_STAGES = 8
STAGING = 8 * 16 * 144  # each consumer warp's 16 rows x (128 + 16) bytes
# dtype -> (panel rows PR: the queries of an attention tile and the rows of
# a phase-2 GEMM; warps NC that share a query group, each with 1/NC of the
# columns of a pass; keys of a K/V tile; the compiled (columns per warp
# DPW, passes over the keys) pairs, HDP = NC x DPW x passes): the one table
# of kernel D's instances. The build compiles exactly these into
# csrc/fused_basic_attn_block.cu's `dispatch` (`instances_header`). bf16
# keeps DPW <= 128: a warp's output accumulators are DPW / 2 registers.
_INSTANCES = {
    torch.bfloat16: (64, 2, 32, ((32, 1), (64, 1), (96, 1), (96, 2), (128, 2))),
    torch.float32: (32, 4, 32, ((16, 1), (32, 1), (48, 1), (96, 1), (128, 1))),
}
_PATHS = {torch.bfloat16: "wgmma", torch.float32: "split TF32"}


class Plan(NamedTuple):
    """Kernel D's instance for one block shape: the linears' path ("wgmma"
    for bf16, "split TF32" mma.sync for float32), whether the weight tiles
    come by TMA (else the producer warp gathers them with plain loads: a
    row of C or E elements that is not a multiple of 16 bytes), the panel
    rows PR, the padded head dim HDP = NC x DPW x passes, the columns per
    warp DPW and the passes over the keys, the ring's stages and the
    block's shared bytes."""
    path: str
    tma: bool
    pr: int
    hdp: int
    dpw: int
    passes: int
    stages: int
    smem: int


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(w, c, e, heads, dtype) -> Plan:
    """The instance for (W, C, E, heads) rows of `dtype`: the smallest
    compiled (DPW, passes) whose HDP = NC x DPW x passes covers the head dim
    (the fewer passes on a tie), then as many ring
    stages (at most 8) as the shared memory left by the two panels (PR rows
    x the widest of C, E and HDP, in 128-byte chunks), the staging and the
    barriers holds; at least one K tile's stages. Raises on what the kernel
    does not take."""
    if dtype not in _INSTANCES:
        raise TypeError(f"dtype {dtype} not supported (float32 or bfloat16)")
    if not (w >= 1 and supports(c, e) and c >= 1 and heads >= 1 and e % heads == 0):
        raise ValueError(f"no kernel D instance for W={w}, C={c}, E={e}, heads={heads}")
    pr, nc, bkv, inst = _INSTANCES[dtype]
    esz = dtype.itemsize
    kch = 128 // esz
    hd = e // heads
    hdp, passes, dpw = min((nc * d * n, n, d) for d, n in inst if nc * d * n >= hd)
    half = pr * _cdiv(max(c, e, hdp), kch) * 128
    fixed = 1024 + 2 * half + STAGING + (2 * MAX_STAGES + 2) * 8
    stages = min(MAX_STAGES, (MAX_SMEM - fixed) // STAGE_BYTES)
    kv_stages = _cdiv(_cdiv(hdp, kch), STAGE_BYTES // (bkv * 128))
    if stages < kv_stages:
        raise ValueError(f"kernel D: no room for a K tile at C={c}, E={e}, hd={hd}")
    tma = (c * esz) % 16 == 0 and (e * esz) % 16 == 0
    return Plan(_PATHS[dtype], tma, pr, hdp, dpw, passes, stages,
                fixed + stages * STAGE_BYTES)


def instances_header() -> str:
    """The C header csrc/fused_basic_attn_block.cu includes from the build
    directory: the geometry of `_INSTANCES` and `plan`, the X-macro list
    S2M2_D_INSTANCES of (dtype code, DPW, passes) instances, and the wgmma wrappers
    of the bf16 products' N tiles (a K tile's keys for the scores, 64 and
    128 columns a warpgroup for the linears)."""
    from .int8_gemm import _wgmma_struct
    bf = _INSTANCES[torch.bfloat16]
    f32 = _INSTANCES[torch.float32]
    cases = [f"X({_DTYPES[dt]}, {d}, {n})" for dt, (_, _, _, inst) in _INSTANCES.items()
             for d, n in inst]
    lines = ["// Generated from _INSTANCES in s2m2_torch/ops/fused_block.py.",
             "#pragma once", "#include <cuda_bf16.h>", "#include <stdint.h>",
             f"#define S2M2_D_PR_BF16 {bf[0]}", f"#define S2M2_D_NC_BF16 {bf[1]}",
             f"#define S2M2_D_BKV_BF16 {bf[2]}",
             f"#define S2M2_D_PR_F32 {f32[0]}", f"#define S2M2_D_NC_F32 {f32[1]}",
             f"#define S2M2_D_BKV_F32 {f32[2]}",
             f"#define S2M2_D_STAGING {STAGING}", f"#define S2M2_D_MAX_STAGES {MAX_STAGES}",
             "template <typename In, int BN> struct Wgmma;",
             *(_wgmma_struct("bf16", n) for n in sorted({bf[2], 64, 128})),
             f"#define S2M2_D_INSTANCES(X) {' '.join(cases)}"]
    return "\n".join(lines) + "\n"


def supports(c, e):
    """Whether a block of width C and inner width E goes to the fused kernel:
    the rule of s2m2_tpu/models/mrt.py:35."""
    return c <= MAX_DIM and e <= MAX_DIM


def _ln(x):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + 1e-5)


def _mm(x, w):
    """x (..., K) @ w (N, K)^T with float32 accumulation, result in x.dtype."""
    return torch.matmul(x.float(), w.float().t()).to(x.dtype)


def _heads_attn(q, k, v, num_heads):
    """Per-head attention of (G, W, E) inputs: float32 scores scaled after
    the dot, float32 softmax, probabilities rounded to v's dtype."""
    hd = q.shape[-1] // num_heads
    outs = []
    for h in range(num_heads):
        sl = slice(h * hd, (h + 1) * hd)
        s = torch.matmul(q[..., sl].float(), k[..., sl].float().transpose(-1, -2))
        s = s * hd ** -0.5
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
        outs.append(torch.matmul(p.float(), v[..., sl].float()).to(v.dtype))
    return torch.cat(outs, dim=-1) if num_heads > 1 else outs[0]


def fused_basic_attn_block_plain(x_rows, y_rows, weights, num_heads):
    """The block on (G, W, C) left rows and their (G, W, C) right partners;
    returns the two views' new rows."""
    (cq, ck, cv, cvb, cp, f1w1, f1b1, f1w2, f1b2,
     sq, sk, sv, svb, sp, f2w1, f2b1, f2w2, f2b2) = weights
    dt = x_rows.dtype

    def ffn(z, w1, b1, w2, b2):
        n = _ln(z).to(dt)
        hdn = F.gelu(_mm(n, w1).float() + b1.float()).to(dt)
        return z + _mm(hdn, w2) + b2.to(dt)

    def qkv(z, wq, wk, wv, wvb):
        n = _ln(z).to(dt)
        return _mm(n, wq), _mm(n, wk), _mm(n, wv) + wvb.to(dt)

    zx, zy = x_rows, y_rows
    qx, kx, vx = qkv(zx, cq, ck, cv, cvb)
    qy, ky, vy = qkv(zy, cq, ck, cv, cvb)
    zx = zx + _mm(_heads_attn(qx, ky, vy, num_heads), cp)
    zy = zy + _mm(_heads_attn(qy, kx, vx, num_heads), cp)
    zx = ffn(zx, f1w1, f1b1, f1w2, f1b2)
    zy = ffn(zy, f1w1, f1b1, f1w2, f1b2)
    outs = []
    for z in (zx, zy):
        q, k, v = qkv(z, sq, sk, sv, svb)
        z = z + _mm(_heads_attn(q, k, v, num_heads), sp)
        outs.append(ffn(z, f2w1, f2b1, f2w2, f2b2))
    return outs[0], outs[1]


def _check(rows, right0, weights, num_heads):
    """Validate the call; returns E."""
    if rows.dim() != 3:
        raise ValueError(f"rows must be (R, W, C), got {tuple(rows.shape)}")
    r, _, c = rows.shape
    if right0 < 1 or r != 2 * right0:
        raise ValueError(f"rows ({r}) must be the left view's right0 = {right0} "
                         "rows then the right view's")
    if len(weights) != N_WEIGHTS:
        raise ValueError(f"expected {N_WEIGHTS} weights, got {len(weights)}")
    e = weights[0].shape[0]
    mat_ec, mat_ce = (e, c), (c, e)
    want = [mat_ec, mat_ec, mat_ec, (e,), mat_ce, mat_ec, (e,), mat_ce, (c,)] * 2
    for i, (t, shape) in enumerate(zip(weights, want)):
        if tuple(t.shape) != shape:
            raise ValueError(f"weight {i}: shape {tuple(t.shape)}, expected {shape}")
    if not supports(c, e):
        raise ValueError(f"the fused block takes C, E <= {MAX_DIM}, got C={c}, E={e}")
    if num_heads < 1 or e % num_heads:
        raise ValueError(f"E = {e} does not split into {num_heads} heads")
    if rows.dtype not in _DTYPES:
        raise TypeError(f"dtype {rows.dtype} not supported (float32 or bfloat16)")
    for t in (rows, *weights):
        if t.dtype != rows.dtype or t.device != rows.device:
            raise ValueError("rows and weights must share dtype and device")
        if not t.is_contiguous():
            raise ValueError("rows and weights must be contiguous")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    return e


def _launch(rows, right0, weights, num_heads, e):
    _, w, c = rows.shape
    pl = plan(w, c, e, num_heads, rows.dtype)
    sms = torch.cuda.get_device_properties(rows.device).multi_processor_count
    blocks = min(right0, sms)  # persistent: one block per SM, each walking pairs
    # q, k, v of each block's pair in flight: (2W, heads, HDP) each
    scratch = torch.empty(3 * blocks * 2 * w * num_heads * pl.hdp, dtype=rows.dtype,
                          device=rows.device)
    out = torch.empty_like(rows)
    ptrs = (ctypes.c_void_p * N_WEIGHTS)(*(t.data_ptr() for t in weights))
    entry = _build.entry("fused_basic_attn_block", "s2m2_fused_basic_attn_block",
                         (ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                          ctypes.c_void_p) + (ctypes.c_int,) * 13)
    _build.call(entry, rows.device, "fused_basic_attn_block", rows.data_ptr(),
                out.data_ptr(), ptrs, scratch.data_ptr(), blocks, right0, right0, w, c, e,
                num_heads, _DTYPES[rows.dtype], pl.dpw, pl.passes, pl.stages, pl.smem,
                int(not pl.tma))
    return out


def fused_basic_attn_block(rows, right0, weights, num_heads):
    """The whole block on (R, W, C) scanline rows: the left view's rows
    [0, right0) first, then their right-view partners; returns new (R, W, C)
    rows in the same layout."""
    e = _check(rows, right0, weights, num_heads)
    if rows.device.type == "cpu":
        ox, oy = fused_basic_attn_block_plain(rows[:right0], rows[right0:], weights,
                                              num_heads)
        return torch.cat([ox, oy])
    return _launch(rows, right0, weights, num_heads, e)
