"""Fused per-row correlation + masking + dustbin Sinkhorn: kernel C.

For each epipolar row: cv = f0 f1^T (float32 accumulate), -1e4 where j > i
under positivity, a zero dustbin row and column, log marginals -log 2W
(pixels) and log 1/2 (dustbin), `ot_iter` Sinkhorn iterations (v over rows,
then u over columns, clamped log-sum-exp), and prob = exp(. + log 2W) on the
[:W, :W] block, zeroed again where j > i. The Sinkhorn runs on the float32
accumulator; cv and prob are returned in f0's dtype, as
`s2m2_tpu/ops/sinkhorn.py` does.

On a CUDA tensor the wrapper launches `csrc/sinkhorn_ot.cu`; on a CPU
tensor it runs the plain version beside it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lse(x, dim):
    m = x.amax(dim=dim, keepdim=True)
    y = torch.exp(x - m).sum(dim=dim, keepdim=True)
    return m + torch.log(y.clamp(min=1e-30))


def fused_correlation_ot_plain(f0, f1, ot_iter=3, use_positivity=True):
    """Step by step as the TPU kernel's `_kernel` (s2m2_tpu/ops/sinkhorn.py)."""
    b, h, w, c = f0.shape
    g = b * h
    cv = torch.matmul(f0.reshape(g, w, c).float(),
                      f1.reshape(g, w, c).float().transpose(1, 2))
    cv_out = cv.to(f0.dtype)
    i = torch.arange(w, device=f0.device).view(1, w, 1)
    j = torch.arange(w, device=f0.device).view(1, 1, w)
    upper = j > i
    if use_positivity:
        cv = cv.masked_fill(upper, -1e4)
    attn = torch.nn.functional.pad(cv, (0, 1, 0, 1))
    idx = torch.arange(w + 1, device=f0.device).view(1, 1, w + 1)
    log_nu = torch.where(idx == w, math.log(w / (2.0 * w)),
                         -math.log(2.0 * w)).float()     # (1,1,W+1)
    log_mu = log_nu.transpose(1, 2)                      # (1,W+1,1)
    v = log_nu - _lse(attn, dim=1)
    u = log_mu - _lse(attn + v, dim=2)
    for _ in range(ot_iter - 1):
        v = log_nu - _lse(attn + u, dim=1)
        u = log_mu - _lse(attn + v, dim=2)
    out = attn + u + v
    prob = torch.exp(out[:, :w, :w] + math.log(2.0 * w))
    if use_positivity:
        prob = prob.masked_fill(upper, 0.0)
    return prob.to(f0.dtype).reshape(b, h, w, w), cv_out.reshape(b, h, w, w)


def fused_correlation_ot(f0, f1, ot_iter=3, use_positivity=True):
    """f0, f1: (B, H, W, C) normalized left/right features. Returns
    (prob, cv), each (B, H, W, W) in f0's dtype: the masked transport
    probabilities and the raw (unmasked) correlation volume."""
    if f0.dim() != 4 or f0.shape != f1.shape or f0.dtype != f1.dtype \
            or f0.device != f1.device:
        raise ValueError("f0 and f1 must be (B, H, W, C) of one shape, dtype "
                         "and device")
    if f0.device.type == "cpu":
        return fused_correlation_ot_plain(f0, f1, ot_iter, use_positivity)
    if f0.device.type != "cuda":
        raise ValueError(f"unsupported device {f0.device}")
    if f0.dtype not in _DTYPES:
        raise TypeError(f"fused_correlation_ot: dtype {f0.dtype} not supported "
                        "(float32 or bfloat16)")
    if not (f0.is_contiguous() and f1.is_contiguous()):
        raise ValueError("fused_correlation_ot: inputs must be contiguous")
    b, h, w, c = f0.shape
    if ot_iter < 1 or w < 1 or c < 1 or b * h < 1:
        raise ValueError(f"fused_correlation_ot: unsupported shape "
                         f"{tuple(f0.shape)} / ot_iter {ot_iter}")
    prob = torch.empty((b, h, w, w), dtype=f0.dtype, device=f0.device)
    cv = torch.empty_like(prob)
    work = torch.empty((b * h, w + 1, w + 1), dtype=torch.float32,
                       device=f0.device)
    entry = _build.entry("sinkhorn_ot", "s2m2_fused_correlation_ot",
                         (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6)
    _build.call(entry, f0.device, "fused_correlation_ot", f0.data_ptr(), f1.data_ptr(),
                cv.data_ptr(), prob.data_ptr(), work.data_ptr(), b * h, w, c, ot_iter,
                int(use_positivity), _DTYPES[f0.dtype])
    return prob, cv
