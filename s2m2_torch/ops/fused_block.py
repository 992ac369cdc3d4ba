"""Fused scanline BasicAttnBlock: kernel D.

One launch applies a whole BasicAttnBlock (cross attention, FFN, self
attention, FFN, each pre-norm with a residual) to every epipolar row pair
of the two views. On a CUDA tensor the wrapper launches the hand-written
kernel of `csrc/fused_basic_attn_block.cu`; on a CPU tensor it runs the
plain version beside it. Numerics follow the TPU kernel's body
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

import torch
import torch.nn.functional as F

from . import _build

MAX_DIM = 512  # C and E the kernel takes (s2m2_tpu/models/mrt.py:25)
N_WEIGHTS = 18
BLOCKS_PER_SM = 2  # the kernel's __launch_bounds__ minimum
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


@functools.lru_cache(maxsize=None)
def _scratch_bytes(blocks, w, c, e, dtype):
    """Global scratch bytes of a launch (the C side's own sizing)."""
    size = _build.library("fused_basic_attn_block").s2m2_fused_block_scratch_bytes
    size.restype = ctypes.c_size_t
    size.argtypes = [ctypes.c_int] * 5
    return size(blocks, w, c, e, dtype)


def _launch(rows, right0, weights, num_heads, e):
    _, w, c = rows.shape
    dtype = _DTYPES[rows.dtype]
    sms = torch.cuda.get_device_properties(rows.device).multi_processor_count
    blocks = min(right0, BLOCKS_PER_SM * sms)
    scratch = torch.empty(_scratch_bytes(blocks, w, c, e, dtype), dtype=torch.uint8,
                          device=rows.device)
    out = torch.empty_like(rows)
    ptrs = (ctypes.c_void_p * N_WEIGHTS)(*(t.data_ptr() for t in weights))
    entry = _build.entry("fused_basic_attn_block", "s2m2_fused_basic_attn_block",
                         (ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                          ctypes.c_void_p) + (ctypes.c_int,) * 8)
    _build.call(entry, rows.device, "fused_basic_attn_block", rows.data_ptr(),
                out.data_ptr(), ptrs, scratch.data_ptr(), blocks, right0, right0, w, c, e,
                num_heads, dtype)
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
