"""Int8 quantize -> int8 tensor-core GEMM -> dequantize: kernel E.

The body of every int8 site (`s2m2_tpu/models/quant.py`) and of the TPU
probe `scripts/probe_pallas_int8.py`, as two launches of
`csrc/int8_gemm.cu`:

- `quantize_pack(x, inv, conv=...)`: int8 rows clip(round(x * inv), -127,
  127), round half to even, with inv = float32(1 / s_x) multiplied (not a
  division). Token inputs (..., K) give (M, Kp) rows; an NCHW input with a
  conv geometry gives its im2col rows, columns in the (c, dy, dx) order of
  an OIHW weight, padding taps 0. Kp is K rounded up to a multiple of 32,
  the extra columns 0.
- `int8_gemm(a, w, w_scale, s_x, bias)`: a (M, Kp) int8 against w (N, Kp)
  int8 (torch's Linear layout), int32 accumulation, then float(acc) *
  (w_scale[n] * s_x) + bias[n], cast to the output dtype; or the raw int32
  accumulators (`out_dtype=torch.int32`).

`bf16_gemm` is the same GEMM on bf16 operands with float32 accumulation
(the probe's `_kernel_bf16` body), and `probe_chain` is the probe itself:
eight chained products through these kernels.

On a CUDA tensor each wrapper launches its kernel (and counts the launch
in `_build.launch_counts`) or raises; on a CPU tensor it runs the plain
version beside it, whose integer products are exact (float64 sums of
int8 products stay below 2**53).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
PROBE_REPS = 8  # products per probe call (scripts/probe_pallas_int8.py REPS)


def k_padded(k: int) -> int:
    """K rounded up to the GEMM's k granule of 32 int8 values."""
    return (k + 31) // 32 * 32


def conv_out_hw(h, w, geom):
    kh, kw, sh, sw, ph, pw = geom
    return (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1


def inv_scale(s_x: float) -> float:
    """float32(1 / s_x), computed in double and narrowed (quant.py:185)."""
    return float(np.float32(1.0 / s_x))


# ---------------------------------------------------------------- plain

def _quantize(x, inv):
    return torch.clamp(torch.round(x.float() * inv), -127.0, 127.0)


def quantize_pack_plain(x, inv, conv=None, rows=None):
    """The plain version of `quantize_pack` (same arguments)."""
    if conv is None:
        k = x.shape[-1]
        q = _quantize(x, inv).reshape(-1, k)
    else:
        kh, kw, sh, sw, ph, pw = conv
        cols = F.unfold(_quantize(x, inv), (kh, kw), padding=(ph, pw), stride=(sh, sw))
        k = cols.shape[1]
        q = cols.transpose(1, 2).reshape(-1, k)
        if rows is not None:
            q = q[rows[0]:rows[1]]
    return F.pad(q, (0, k_padded(k) - k)).to(torch.int8)


def int8_gemm_plain(a, w, w_scale=None, s_x=1.0, bias=None, out_dtype=torch.bfloat16):
    """(M, N) = a w^T summed exactly, then the dequantizing epilogue."""
    acc = torch.matmul(a.double(), w.double().t())
    if out_dtype == torch.int32:
        return acc.to(torch.int32)
    y = acc.float()
    if w_scale is not None:
        y = y * (w_scale.float() * torch.tensor(s_x, dtype=torch.float32))
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def bf16_gemm_plain(a, w, out_dtype=torch.bfloat16):
    return torch.matmul(a.float(), w.float().t()).to(out_dtype)


def _write_nchw(out, rows, m_base):
    """Rows m_base .. m_base + len(rows) of an NCHW output, row m = (b, hw)."""
    b, n, h, w = out.shape
    hw = h * w
    o = out.view(b, n, hw)
    i, m = 0, m_base
    while i < rows.shape[0]:
        bb, p = divmod(m, hw)
        take = min(hw - p, rows.shape[0] - i)
        o[bb, :, p:p + take] = rows[i:i + take].t()
        i += take
        m += take


def probe_chain_plain(x, w, kind):
    return _probe_chain(x, w, kind, quantize_pack_plain, int8_gemm_plain, bf16_gemm_plain)


# ---------------------------------------------------------------- wrappers

def _device(t, name):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _token_rows(x, name):
    """(inner, ld, outer) of x's rows: a contiguous (..., K) tensor, or a 3D
    view (b, n, K) whose last axis is contiguous (one head of a (B, heads,
    N, d) tensor)."""
    if x.is_contiguous():
        return x.numel() // x.shape[-1], x.shape[-1], 0
    if x.dim() == 3 and x.stride(2) == 1:
        return x.shape[1], x.stride(1), x.stride(0)
    raise ValueError(f"{name}: token input must be contiguous or a (b, n, K) view "
                     f"with a contiguous last axis, got shape {tuple(x.shape)} "
                     f"strides {x.stride()}")


def quantize_pack(x, inv, conv=None, rows=None):
    """Quantize x to int8 GEMM rows.

    conv None: x is (..., K) tokens; returns (M, Kp) with M the product of
    the leading dims. conv = (kh, kw, sh, sw, ph, pw): x is (B, C, H, W);
    returns the im2col rows (B * Ho * Wo, Kp), or rows[0]:rows[1] of them.
    """
    name = "int8_quantize_pack"
    if not _device(x, name):
        return quantize_pack_plain(x, inv, conv, rows)
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32 or bfloat16)")
    lib = _build.library("int8_gemm")
    with torch.cuda.device(x.device):
        if conv is None:
            k = x.shape[-1]
            inner, ld, outer = _token_rows(x, name)
            m = x.numel() // k
            q = torch.empty((m, k_padded(k)), dtype=torch.int8, device=x.device)
            fn = lib.s2m2_quantize_rows
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                                    ctypes.c_int] + [ctypes.c_longlong] * 3
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            err = fn(x.data_ptr(), q.data_ptr(), m, k, q.shape[1], inner, ld, outer,
                     inv, _DTYPES[x.dtype], _stream(x))
        else:
            if x.dim() != 4 or not x.is_contiguous():
                raise ValueError(f"{name}: a conv input must be a contiguous NCHW tensor")
            b, c, h, w = x.shape
            kh, kw, sh, sw, ph, pw = conv
            ho, wo = conv_out_hw(h, w, conv)
            m0, m1 = rows if rows is not None else (0, b * ho * wo)
            if not 0 <= m0 < m1 <= b * ho * wo:
                raise ValueError(f"{name}: rows {rows} outside [0, {b * ho * wo})")
            q = torch.empty((m1 - m0, k_padded(c * kh * kw)), dtype=torch.int8,
                            device=x.device)
            fn = lib.s2m2_quantize_im2col
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
                           + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_int,
                                                    ctypes.c_void_p])
            err = fn(x.data_ptr(), q.data_ptr(), m0, m1 - m0, c, h, w, ho, wo, kh, kw,
                     sh, sw, ph, pw, q.shape[1], inv, _DTYPES[x.dtype], _stream(x))
    _build.check(lib, err, name)
    _build.launch_counts[name] += 1
    return q


def _check_operand(t, name, what, dtype, granule):
    if t.dtype != dtype or t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{name}: {what} must be a 2D {dtype} tensor with a "
                         f"contiguous last axis, got {t.dtype} {tuple(t.shape)}")
    if t.shape[1] % granule or t.stride(0) % (16 // t.element_size()) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} needs K % {granule} == 0 and 16-byte "
                         f"aligned rows, got shape {tuple(t.shape)} stride {t.stride()}")


def int8_gemm(a, w, w_scale=None, s_x=1.0, bias=None, out_dtype=torch.bfloat16,
              out=None, m_base=0):
    """a (M, Kp) int8 rows against w (N, Kp) int8: returns (M, N) in
    out_dtype (float32, bfloat16, or int32 for the raw accumulators). With
    `out` an NCHW (B, N, H, W) tensor, writes rows m_base .. m_base + M of
    it (row m = (b, h * W + w)) and returns it."""
    name = "int8_gemm"
    cuda = _device(a, name)
    if a.device != w.device or a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"{name}: a {tuple(a.shape)} and w {tuple(w.shape)} do not "
                         "match")
    if out_dtype not in _OUT_KINDS or (out is not None and out.dtype != out_dtype):
        raise TypeError(f"{name}: output dtype {out_dtype} not supported")
    if (w_scale is None) != (out_dtype == torch.int32):
        raise ValueError(f"{name}: w_scale is required exactly when dequantizing")
    m, n = a.shape[0], w.shape[0]
    if not cuda:
        y = int8_gemm_plain(a, w, w_scale, s_x, bias, out_dtype)
        if out is None:
            return y
        _write_nchw(out, y, m_base)
        return out
    _check_operand(a, name, "a", torch.int8, 32)
    _check_operand(w, name, "w", torch.int8, 32)
    for t, what in ((w_scale, "w_scale"), (bias, "bias")):
        if t is not None and (t.dtype != torch.float32 or t.shape != (n,)
                              or not t.is_contiguous() or t.device != a.device):
            raise ValueError(f"{name}: {what} must be a contiguous float32 ({n},) "
                             "tensor on a's device")
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
        ldc, hw = n, 0
    else:
        if out.dim() != 4 or out.shape[1] != n or not out.is_contiguous() \
                or out.device != a.device:
            raise ValueError(f"{name}: out must be a contiguous (B, {n}, H, W) tensor")
        ldc, hw = 0, out.shape[2] * out.shape[3]
        if not 0 <= m_base <= out.shape[0] * hw - m:
            raise ValueError(f"{name}: rows {m_base}..{m_base + m} outside out")
    lib = _build.library("int8_gemm")
    fn = lib.s2m2_int8_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), a.stride(0), w.data_ptr(), w.stride(0), m, n, a.shape[1],
                 None if w_scale is None else w_scale.data_ptr(), float(s_x),
                 None if bias is None else bias.data_ptr(), out.data_ptr(), ldc, hw,
                 m_base, _OUT_KINDS[out_dtype], _stream(a))
    _build.check(lib, err, name)
    _build.launch_counts[name] += 1
    return out


def bf16_gemm(a, w, out_dtype=torch.bfloat16):
    """a (M, K) bf16 against w (N, K) bf16, float32 accumulation: (M, N)."""
    name = "bf16_gemm"
    if a.device != w.device or a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"{name}: a {tuple(a.shape)} and w {tuple(w.shape)} do not match")
    if not _device(a, name):
        return bf16_gemm_plain(a, w, out_dtype)
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: output dtype {out_dtype} not supported")
    _check_operand(a, name, "a", torch.bfloat16, 16)
    _check_operand(w, name, "w", torch.bfloat16, 16)
    out = torch.empty((a.shape[0], w.shape[0]), dtype=out_dtype, device=a.device)
    lib = _build.library("int8_gemm")
    fn = lib.s2m2_bf16_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), a.stride(0), w.data_ptr(), w.stride(0), a.shape[0],
                 w.shape[0], a.shape[1], out.data_ptr(), out.shape[1],
                 _OUT_KINDS[out_dtype], _stream(a))
    _build.check(lib, err, name)
    _build.launch_counts[name] += 1
    return out


def _probe_chain(x, w, kind, pack, gemm, gemm_bf16):
    g, n, c = x.shape
    wt = w.t().contiguous()  # the probe's (in, out) weight as (N, K)
    h = x.reshape(g * n, c)
    if kind == "int8":
        # q = clip(round(h * 8)); acc * (1/8/127): w_scale 1/127 times s_x 1/8
        w_scale = torch.full((c,), np.float32(1.0 / 127.0), dtype=torch.float32,
                             device=x.device)
        for _ in range(PROBE_REPS):
            h = gemm(pack(h, 8.0), wt, w_scale, 0.125, None, torch.bfloat16)
    elif kind == "bf16":
        for _ in range(PROBE_REPS):
            h = gemm_bf16(h, wt, torch.bfloat16)
    else:
        raise ValueError(f"probe_chain: kind must be 'int8' or 'bf16', got {kind!r}")
    return h.reshape(g, n, c)


def probe_chain(x, w, kind):
    """Kernel E as the TPU probe runs it: x (G, W, C) bf16 through 8 chained
    products with w (C, C) in the probe's (in, out) layout, int8 (kind
    "int8": quantize by 8, int8 dot, dequantize by 1/8/127 to bf16) or bf16
    (kind "bf16": float32 accumulation, cast to bf16)."""
    if x.dim() != 3 or w.shape != (x.shape[2], x.shape[2]) or x.dtype != torch.bfloat16:
        raise ValueError(f"probe_chain: x must be (G, W, C) bf16 and w (C, C), got "
                         f"{tuple(x.shape)} {x.dtype} and {tuple(w.shape)}")
    want = torch.int8 if kind == "int8" else torch.bfloat16
    if w.dtype != want:
        raise TypeError(f"probe_chain: kind {kind!r} takes a {want} weight")
    return _probe_chain(x, w, kind, quantize_pack, int8_gemm, bf16_gemm)
