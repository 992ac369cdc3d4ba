"""Fused per-row correlation + masking + dustbin Sinkhorn: kernel C.

For each epipolar row: cv = f0 f1^T (float32 accumulate), -1e4 where j > i
under positivity, a zero dustbin row and column, log marginals -log 2W
(pixels) and log 1/2 (dustbin), `ot_iter` Sinkhorn iterations (v over rows,
then u over columns, clamped log-sum-exp), and prob = exp(. + log 2W) on the
[:W, :W] block, zeroed again where j > i. The Sinkhorn runs on the float32
accumulator; cv and prob are returned in f0's dtype, as
`s2m2_tpu/ops/sinkhorn.py` does.

On a CUDA tensor the wrapper launches `csrc/sinkhorn_ot.cu` by the route
`plan(W, C, dtype, positivity)` chooses; on a CPU tensor it runs the plain
version beside it. The resident route keeps the whole float32 row in the
shared memory of a thread-block cluster of up to 8 CTAs (`cluster`) and
needs no workspace; the streamed route, for rows too wide for a cluster,
keeps it in a (B*H, W+1, W+1) float32 workspace the wrapper allocates.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448          # shared bytes one block may use on the H100
THREADS = 512                # per CTA of the resident route
_JOBS_PER_WARP = 2           # bf16: 32 x 32 correlation tiles a warp owns per pass
_FFMA_ROWS, _FFMA_COLS = 80, 160  # float32: a pass's rows and columns (5 x 5 a thread)
_MAX_ITEM_GROUPS = 10        # 16-row column-sweep groups a CTA holds
_MAX_STREAMED_W = 3071       # the streamed kernel keeps u and v in 24 KB
_CLUSTERS = (1, 2, 4, 8)
# (chunk bytes per staged row, stages), in order of preference: the
# deepest prefetch that fits
_STAGING = ((64, 6), (64, 5), (64, 4), (64, 3), (64, 2), (32, 4), (32, 3), (32, 2))


class Plan(NamedTuple):
    """How kernel C runs one shape. `route` "resident": a cluster of
    `cluster` CTAs of `threads` threads per row, each holding `rows` rows
    of the masked float32 W x W block in shared memory; the correlation in
    `passes` passes of `cols` columns, its operands staged `chunk` bytes a
    row through `stages` stages; `smem` dynamic shared bytes a CTA.
    "streamed": one block per row, the row in a global workspace
    (`smem` its u and v)."""
    route: str
    cluster: int
    rows: int
    cols: int
    passes: int
    stages: int
    chunk: int
    smem: int
    threads: int


def _cdiv(a, b):
    return -(-a // b)


def _resident_smem(w, k, cols, stages, chunk):
    """Dynamic shared bytes of one resident CTA, the layout of
    csrc/sinkhorn_ot.cu's `make_layout`: the slab (R rows of pitch P >= W,
    P % 8 == 4), v, u (16 MT entries), two buffers of per-column (max, sum)
    partials, u_W and the stages' mbarriers, then one 1024-aligned region
    (hence 1024 bytes of slack) used in turn by the correlation's staging
    stages (dense rows of `chunk` bytes), the column sweeps' and the row
    sweeps' per-item partials."""
    r = _cdiv(w, k)
    mt = _cdiv(r, 16)
    pitch = w + (4 - w) % 8
    vn = _cdiv(w + 1, 4) * 4
    ncp = _cdiv(w, 16) | 1
    r32 = 32 * _cdiv(r, 32)
    region = max(stages * (16 * mt + cols) * chunk, 2 * mt * vn * 4, 2 * r32 * ncp * 4)
    return r * pitch * 4 + vn * 4 + 16 * mt * 4 + 2 * vn * 8 + 16 + 8 * 6 + 1024 + region


def _resident(w, k, dtype):
    """The first resident plan of cluster size k that fits, by fewest
    passes then `_STAGING`'s order; None if none fits. bf16 runs the
    correlation on mma.sync, at most 2 32 x 32 tiles a warp a pass;
    float32 by FFMA, at most 80 rows and 160 columns a pass."""
    r = _cdiv(w, k)
    mt = _cdiv(r, 16)
    nb = _cdiv(w, 16)
    if mt > _MAX_ITEM_GROUPS or 16 * mt > 256:
        return None
    if dtype == torch.float32:
        if 16 * mt > _FFMA_ROWS:
            return None
        max_nbp = min(nb, _FFMA_COLS // 16)
    else:
        max_nbp = min(nb, 2 * (THREADS // 32 * _JOBS_PER_WARP // _cdiv(mt, 2)))
    for passes in range(_cdiv(nb, max_nbp), nb + 1):
        nbp = _cdiv(nb, passes)
        for chunk, stages in _STAGING:
            smem = _resident_smem(w, k, 16 * nbp, stages, chunk)
            if smem <= SMEM_LIMIT:
                return Plan("resident", k, r, 16 * nbp, _cdiv(nb, nbp), stages, chunk, smem,
                            THREADS)
    return None


@functools.lru_cache(maxsize=None)
def plan(w, c, dtype, positivity=True) -> Plan:
    """The route of kernel C for rows of width `w` and `c` channels, by
    shape alone: the resident route with the smallest cluster whose CTAs
    hold the row (fewer CTAs a row: less of the sweeps' merging repeated in
    every CTA, and fewer waves), its correlation in as few passes over
    column ranges as fit; the streamed route for rows no cluster of at
    most 8 CTAs holds. The layout depends on the dtype (the float32
    correlation takes at most 80 rows a CTA), not on `c` or `positivity`,
    which only decide how long the k loop is and what is swept."""
    if dtype not in _DTYPES:
        raise TypeError(f"fused_correlation_ot: dtype {dtype} not supported "
                        "(float32 or bfloat16)")
    if w < 1 or c < 1:
        raise ValueError(f"fused_correlation_ot: unsupported width {w} / channels {c}")
    for k in _CLUSTERS:
        p = _resident(w, k, dtype)
        if p is not None:
            return p
    if w > _MAX_STREAMED_W:
        raise ValueError(f"fused_correlation_ot: width {w} above {_MAX_STREAMED_W}")
    return Plan("streamed", 1, w, w, 1, 1, 0, 2 * (w + 1) * 4, 256)


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
    p = plan(w, c, f0.dtype, bool(use_positivity))
    prob = torch.empty((b, h, w, w), dtype=f0.dtype, device=f0.device)
    cv = torch.empty_like(prob)
    work = None
    if p.route == "streamed":
        work = torch.empty((b * h, w + 1, w + 1), dtype=torch.float32,
                           device=f0.device)
    entry = _build.entry("sinkhorn_ot", "s2m2_fused_correlation_ot",
                         (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 12)
    _build.call(entry, f0.device, "fused_correlation_ot", f0.data_ptr(), f1.data_ptr(),
                cv.data_ptr(), prob.data_ptr(), None if work is None else work.data_ptr(),
                b * h, w, c, ot_iter, int(use_positivity), _DTYPES[f0.dtype],
                int(p.route == "resident"), p.cluster, p.cols, p.stages, p.chunk, p.smem)
    return prob, cv
