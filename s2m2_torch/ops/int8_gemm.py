"""Int8 quantize -> int8 tensor-core GEMM -> dequantize: kernel E.

The body of every int8 site (`s2m2_tpu/models/quant.py`) and of the TPU
probe `scripts/probe_pallas_int8.py`, as one pack and one GEMM launch of
`csrc/int8_gemm.cu`:

- `quantize_pack(x, inv, conv=..., nhwc=...)`: int8 values clip(round(x *
  inv), -127, 127), round half to even, with inv = float32(1 / s_x)
  multiplied (not a division). Token inputs (..., K) give (M, Kp) rows;
  an NCHW input with `nhwc=True` gives one NHWC tensor (B, H, W, Cp), which
  the GEMM's conv mode reads as an implicit GEMM; an NCHW input with a conv
  geometry gives its explicit im2col rows, columns in the (c, dy, dx) order
  of an OIHW weight, padding taps 0 (the path of convs with C below
  `IMPLICIT_MIN_C`). Kp and Cp are K and C rounded up to a multiple of 32,
  the extra columns 0.
- `int8_gemm(a, w, w_scale, s_x, bias, conv=...)`: a (M, Kp) int8 rows
  against w (N, Kp) int8 (torch's Linear layout), or, with a conv geometry,
  a's NHWC tensor against w (N, kh * kw * Cp) in (dy, dx, c) order
  (`conv_weight_taps`); int32 accumulation by wgmma, then float(acc) *
  (w_scale[n] * s_x) + bias[n], cast to the output dtype; or the raw int32
  accumulators (`out_dtype=torch.int32`).

`bf16_gemm` is the same GEMM kernel on bf16 operands with float32
accumulation (the probe's `_kernel_bf16` body), and `probe_chain` is the
probe itself: eight chained products through these kernels. The GEMM's
instance (N tile, consumer warpgroups, stages) comes from `plan`, whose
table `_INSTANCES` the build compiles (`instances_header`).

On a CUDA tensor each wrapper launches its kernel (and counts the launch
in `_build.launch_counts`) or raises; on a CPU tensor it runs the plain
version beside it, whose integer products are exact (float64 sums of
int8 products stay below 2**53).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
PROBE_REPS = 8  # products per probe call (scripts/probe_pallas_int8.py REPS)
# a conv whose input has at least this many channels runs as an implicit
# GEMM on its NHWC int8 tensor; below it a tap's channels fill less than one
# 32-byte k-step, and the explicit im2col rows stay
IMPLICIT_MIN_C = 32
MAX_SMEM = 232448  # shared bytes a block may use on the H100
# operand -> {(N tile, consumer warpgroups): stages}: the one table of GEMM
# instances. A block is 64 * warpgroups output rows by the N tile; a stage
# holds both operands' 128-byte-deep k tiles. The build compiles exactly
# these into csrc/int8_gemm.cu's `dispatch` (through `instances_header`)
_TILES = {(32, 1): 8, (32, 2): 8, (64, 1): 8, (64, 2): 8, (128, 1): 8, (128, 2): 6,
          (128, 3): 4, (192, 1): 6, (192, 2): 5, (192, 3): 4, (256, 1): 5, (256, 2): 4}
_INSTANCES = {"int8": dict(_TILES), "bf16": dict(_TILES)}
_OPS = {"int8": 0, "bf16": 1}
N_TILES = sorted({bn for bn, _ in _TILES})


def k_padded(k: int) -> int:
    """K rounded up to the GEMM's k granule of 32 int8 values."""
    return (k + 31) // 32 * 32


def conv_out_hw(h, w, geom):
    kh, kw, sh, sw, ph, pw = geom
    return (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1


def inv_scale(s_x: float) -> float:
    """float32(1 / s_x), computed in double and narrowed (quant.py:185)."""
    return float(np.float32(1.0 / s_x))


def implicit(c: int) -> bool:
    """Whether a conv with c input channels runs as an implicit GEMM."""
    return c >= IMPLICIT_MIN_C


def tap_tiles(conv, cp) -> bool:
    """Whether the conv mode loads A by TMA, one box of 128 channels x a
    block of output pixels per tap (stride 1, Cp a multiple of 128), rather
    than gathering its rows with cp.async."""
    return conv[2] == conv[3] == 1 and cp % 128 == 0


class Plan(NamedTuple):
    """The GEMM instance for one call: N tile, consumer warpgroups (64 rows
    each), ring stages, and the block's shared bytes."""
    bn: int
    wgs: int
    stages: int
    smem: int


def _smem(bn, wgs, stages):
    """Shared bytes of a block: the ring, its barriers, each warp's 16 x 144
    byte epilogue staging, each warpgroup's scale and bias tables, and 1,024
    bytes of alignment slack (csrc `Smem::BYTES`)."""
    return (1024 + stages * (64 * wgs + bn) * 128 + 16 * stages + 4 * wgs * 16 * 144
            + wgs * 2 * bn * 4)


@functools.lru_cache(maxsize=4096)
def plan(operand, m, n, sms=132, conv=False) -> Plan:
    """The instance for an (m, n) output: the fewest N tiles of at most 256
    columns, then the narrowest tile that keeps that count (so N = 8 runs a
    32-wide tile and N = 384 two 192-wide ones); then three consumer
    warpgroups (192 rows a block; N tiles up to 192, whose accumulators fit
    the 152 registers a thread they get) where that still gives each of the
    `sms` multiprocessors two tiles, else two (128 rows) where the tiles
    cover the multiprocessors, else one (64 rows). Taller tiles read each
    weight tile fewer times. `conv` (the implicit GEMM's cp.async gather)
    takes at most two: the gathering producer needs the registers three
    would take from it."""
    table = _INSTANCES.get(operand)
    if table is None:
        raise ValueError(f"operand {operand!r} not supported (int8 or bf16)")
    if m < 1 or n < 1:
        raise ValueError(f"empty GEMM ({m}, {n})")
    tiles = -(-n // max(N_TILES))
    bn = min(b for b in N_TILES if -(-n // b) == tiles)
    if not conv and (bn, 3) in table and -(-m // 192) * tiles >= 2 * sms:
        wgs = 3
    else:
        wgs = 2 if -(-m // 128) * tiles >= sms else 1
    stages = table[(bn, wgs)]
    return Plan(bn, wgs, stages, _smem(bn, wgs, stages))


def _wgmma_struct(operand, bn):
    """The C++ specialization Wgmma<In, BN>: one wgmma of a 64 x BN x 32-byte
    step from two shared-memory descriptors into BN / 2 accumulators, added
    to them (scale_d 1) or overwriting them (scale_d 0)."""
    regs = bn // 2
    if operand == "int8":
        ctype, acc, con = "int8_t", "int", "+r"
        instr = f"wgmma.mma_async.sync.aligned.m64n{bn}k32.s32.s8.s8"
        tail = "p"
    else:
        ctype, acc, con = "__nv_bfloat16", "float", "+f"
        instr = f"wgmma.mma_async.sync.aligned.m64n{bn}k16.f32.bf16.bf16"
        tail = "p, 1, 1, 0, 0"
    outs = ", ".join(f"%{i}" for i in range(regs))
    cons = ", ".join(f'"{con}"(d[{i}])' for i in range(regs))
    return (f"template <> struct Wgmma<{ctype}, {bn}> {{\n"
            f"  static __device__ __forceinline__ void mma({acc} (&d)[{regs}], uint64_t a,"
            f" uint64_t b, int scale_d) {{\n"
            f'    asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"\n'
            f'                 "{instr} {{{outs}}}, %{regs}, %{regs + 1}, {tail};\\n}}\\n"\n'
            f"                 : {cons}\n"
            f'                 : "l"(a), "l"(b), "r"(scale_d));\n'
            f"  }}\n}};\n")


def instances_header() -> str:
    """The C header csrc/int8_gemm.cu includes from the build directory:
    `_INSTANCES` as the X-macro list S2M2_GEMM_INSTANCES, X(operand, N tile,
    warpgroups, stages) for each compiled instance (operand 0 int8, 1
    bf16), and the wgmma wrapper of each (operand, N tile) they use."""
    lines = ["// Generated from _INSTANCES in s2m2_torch/ops/int8_gemm.py.",
             "#pragma once", "#include <cuda_bf16.h>", "#include <stdint.h>",
             "template <typename In, int BN> struct Wgmma;"]
    cases = []
    for operand, table in _INSTANCES.items():
        for (bn, wgs), stages in sorted(table.items()):
            cases.append(f"X({_OPS[operand]}, {bn}, {wgs}, {stages})")
        for bn in sorted({bn for bn, _ in table}):
            lines.append(_wgmma_struct(operand, bn))
    lines.append(f"#define S2M2_GEMM_INSTANCES(X) {' '.join(cases)}")
    return "\n".join(lines) + "\n"


def conv_weight_taps(w_q, c, kh, kw):
    """A conv's prequantized (N, Kp) weight, columns in the (c, dy, dx)
    order of an OIHW weight, reordered to (N, kh * kw * Cp) in (dy, dx, c)
    order with zero columns for the padded channels: the weight of the
    GEMM's conv mode. The int8 values are moved, not requantized."""
    n = w_q.shape[0]
    cp = k_padded(c)
    taps = w_q[:, :c * kh * kw].reshape(n, c, kh, kw).permute(0, 2, 3, 1)
    return F.pad(taps, (0, cp - c)).reshape(n, kh * kw * cp).contiguous()


# ---------------------------------------------------------------- plain

def _quantize(x, inv):
    return torch.clamp(torch.round(x.float() * inv), -127.0, 127.0)


def quantize_pack_plain(x, inv, conv=None, rows=None, nhwc=False):
    """The plain version of `quantize_pack` (same arguments)."""
    if nhwc:
        c = x.shape[1]
        q = _quantize(x, inv).permute(0, 2, 3, 1)
        return F.pad(q, (0, k_padded(c) - c)).to(torch.int8).contiguous()
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


def conv_rows_plain(a, conv):
    """The implicit GEMM's A rows, written out: the NHWC int8 tensor a (B, H,
    W, Cp) unfolded into (B * Ho * Wo, kh * kw * Cp) rows in (dy, dx, c)
    order, 0 for padding taps."""
    kh, kw, sh, sw, ph, pw = conv
    b, h, w, cp = a.shape
    ho, wo = conv_out_hw(h, w, conv)
    x = F.pad(a.permute(0, 3, 1, 2).double(), (pw, pw, ph, ph))
    taps = [x[:, :, dy:dy + sh * (ho - 1) + 1:sh, dx:dx + sw * (wo - 1) + 1:sw]
            for dy in range(kh) for dx in range(kw)]
    return torch.stack(taps, 1).permute(0, 3, 4, 1, 2).reshape(b * ho * wo, kh * kw * cp)


def int8_gemm_plain(a, w, w_scale=None, s_x=1.0, bias=None, out_dtype=torch.bfloat16,
                    conv=None):
    """(M, N) = a w^T summed exactly, then the dequantizing epilogue; with
    `conv`, a is the NHWC int8 tensor and its rows are `conv_rows_plain`."""
    rows = conv_rows_plain(a, conv) if conv is not None else a.double()
    acc = torch.matmul(rows, w.double().t())
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

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ROWS = ("s2m2_quantize_rows", (_P, _P, _L, _I, _I, _L, _L, _L, _F, _I))
_NHWC = ("s2m2_quantize_nhwc", (_P, _P, _I, _I, _L, _I, _F, _I))
_IM2COL = ("s2m2_quantize_im2col", (_P, _P, _L, _L) + (_I,) * 12 + (_F, _I))
_GEMM = ("s2m2_gemm", (_P, _L, _P, _L, _L, _I, _I, _I, _P, _F, _P, _P, _L, _L, _L) + (_I,) * 4)
_CONV = ("s2m2_conv_gemm", (_P,) + (_I,) * 12 + (_P, _L, _I, _P, _F, _P, _P, _L, _L, _L)
         + (_I,) * 5)


def _entry(spec):
    return _build.entry("int8_gemm", spec[0], spec[1])


def _device(t, name):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def quantize_pack(x, inv, conv=None, rows=None, nhwc=False):
    """Quantize x to int8 for the GEMM.

    Token rows (conv None, nhwc False): x is (..., K); returns (M, Kp) with M
    the product of the leading dims. nhwc True: x is (B, C, H, W); returns
    the NHWC int8 tensor (B, H, W, Cp) the conv mode reads. conv = (kh, kw,
    sh, sw, ph, pw): x is (B, C, H, W); returns the explicit im2col rows (B
    * Ho * Wo, Kp), or rows[0]:rows[1] of them.
    """
    name = "int8_quantize_pack"
    if not _device(x, name):
        return quantize_pack_plain(x, inv, conv, rows, nhwc)
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32 or bfloat16)")
    if nhwc or conv is not None:
        if x.dim() != 4 or not x.is_contiguous():
            raise ValueError(f"{name}: a conv input must be a contiguous NCHW tensor")
    if nhwc:
        b, c, h, w = x.shape
        q = torch.empty((b, h, w, k_padded(c)), dtype=torch.int8, device=x.device)
        _build.call(_entry(_NHWC), x.device, name, x.data_ptr(), q.data_ptr(), b, c, h * w,
                    q.shape[3], inv, _DTYPES[x.dtype])
    elif conv is None:
        k = x.shape[-1]
        inner, ld, outer = _token_rows(x, name)
        m = x.numel() // k
        q = torch.empty((m, k_padded(k)), dtype=torch.int8, device=x.device)
        _build.call(_entry(_ROWS), x.device, name, x.data_ptr(), q.data_ptr(), m, k,
                    q.shape[1], inner, ld, outer, inv, _DTYPES[x.dtype])
    else:
        b, c, h, w = x.shape
        kh, kw, sh, sw, ph, pw = conv
        ho, wo = conv_out_hw(h, w, conv)
        m0, m1 = rows if rows is not None else (0, b * ho * wo)
        if not 0 <= m0 < m1 <= b * ho * wo:
            raise ValueError(f"{name}: rows {rows} outside [0, {b * ho * wo})")
        q = torch.empty((m1 - m0, k_padded(c * kh * kw)), dtype=torch.int8, device=x.device)
        _build.call(_entry(_IM2COL), x.device, name, x.data_ptr(), q.data_ptr(), m0,
                    m1 - m0, c, h, w, ho, wo, kh, kw, sh, sw, ph, pw, q.shape[1], inv,
                    _DTYPES[x.dtype])
    return q


def _check_operand(t, name, what, dtype, granule):
    if t.dtype != dtype or t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{name}: {what} must be a 2D {dtype} tensor with a "
                         f"contiguous last axis, got {t.dtype} {tuple(t.shape)}")
    if t.shape[1] % granule or t.stride(0) % (16 // t.element_size()) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} needs K % {granule} == 0 and 16-byte "
                         f"aligned rows, got shape {tuple(t.shape)} stride {t.stride()}")


def _out(out, m, n, out_dtype, dev, m_base, name):
    """(out, ldc, hw): a new row-major (m, n) output, or the NCHW `out`."""
    if out is None:
        return torch.empty((m, n), dtype=out_dtype, device=dev), n, 0
    if out.dim() != 4 or out.shape[1] != n or not out.is_contiguous() or out.device != dev:
        raise ValueError(f"{name}: out must be a contiguous (B, {n}, H, W) tensor")
    hw = out.shape[2] * out.shape[3]
    if not 0 <= m_base <= out.shape[0] * hw - m:
        raise ValueError(f"{name}: rows {m_base}..{m_base + m} outside out")
    return out, 0, hw


def int8_gemm(a, w, w_scale=None, s_x=1.0, bias=None, out_dtype=torch.bfloat16,
              out=None, m_base=0, conv=None):
    """a (M, Kp) int8 rows against w (N, Kp) int8: returns (M, N) in
    out_dtype (float32, bfloat16, or int32 for the raw accumulators). With
    `out` an NCHW (B, N, H, W) tensor, writes rows m_base .. m_base + M of
    it (row m = (b, h * W + w)) and returns it. With conv = (kh, kw, sh, sw,
    ph, pw), a is the NHWC int8 tensor (B, H, W, Cp) of `quantize_pack(...,
    nhwc=True)`, w is (N, kh * kw * Cp) in (dy, dx, c) order
    (`conv_weight_taps`) and the rows are the conv's outputs (b, ho, wo); a
    1x1 stride-1 conv is the row case on a's pixels."""
    name = "int8_gemm"
    cuda = _device(a, name)
    if conv is not None and tuple(conv[:4]) == (1, 1, 1, 1) and conv[4:] == (0, 0):
        if a.dim() != 4:
            raise ValueError(f"{name}: conv mode takes the NHWC (B, H, W, Cp) tensor")
        a, conv = a.reshape(-1, a.shape[3]), None
    if conv is not None:
        if a.dim() != 4 or a.dtype != torch.int8 or not a.is_contiguous() \
                or a.shape[3] % 32:
            raise ValueError(f"{name}: conv mode takes a contiguous NHWC int8 (B, H, W, "
                             f"Cp) tensor with Cp % 32 == 0, got {tuple(a.shape)}")
        kh, kw, sh, sw, ph, pw = conv
        b, h, wd, cp = a.shape
        ho, wo = conv_out_hw(h, wd, conv)
        m, depth = b * ho * wo, kh * kw * cp
    else:
        if a.dim() != 2:
            raise ValueError(f"{name}: a must be (M, Kp) rows, got {tuple(a.shape)}")
        m, depth = a.shape
    if a.device != w.device or w.dim() != 2 or w.shape[1] != depth:
        raise ValueError(f"{name}: a {tuple(a.shape)} and w {tuple(w.shape)} do not "
                         "match")
    if out_dtype not in _OUT_KINDS or (out is not None and out.dtype != out_dtype):
        raise TypeError(f"{name}: output dtype {out_dtype} not supported")
    if (w_scale is None) != (out_dtype == torch.int32):
        raise ValueError(f"{name}: w_scale is required exactly when dequantizing")
    n = w.shape[0]
    if not cuda:
        y = int8_gemm_plain(a, w, w_scale, s_x, bias, out_dtype, conv)
        if out is None:
            return y
        _write_nchw(out, y, m_base)
        return out
    if conv is None:
        _check_operand(a, name, "a", torch.int8, 32)
    elif a.data_ptr() % 16:
        raise ValueError(f"{name}: the NHWC tensor must be 16-byte aligned")
    _check_operand(w, name, "w", torch.int8, 32)
    for t, what in ((w_scale, "w_scale"), (bias, "bias")):
        if t is not None and (t.dtype != torch.float32 or t.shape != (n,)
                              or not t.is_contiguous() or t.device != a.device):
            raise ValueError(f"{name}: {what} must be a contiguous float32 ({n},) "
                             "tensor on a's device")
    out, ldc, hw = _out(out, m, n, out_dtype, a.device, m_base, name)
    tiled = conv is not None and tap_tiles(conv, a.shape[3])
    p = plan("int8", m, n, _sms(a.device.index), conv is not None and not tiled)
    scale = None if w_scale is None else w_scale.data_ptr()
    bias_p = None if bias is None else bias.data_ptr()
    if conv is None:
        _build.call(_entry(_GEMM), a.device, name, a.data_ptr(), a.stride(0), w.data_ptr(),
                    w.stride(0), m, n, depth, _OPS["int8"], scale, float(s_x), bias_p,
                    out.data_ptr(), ldc, hw, m_base, _OUT_KINDS[out_dtype], p.bn, p.wgs,
                    p.stages)
    else:
        _build.call(_entry(_CONV), a.device, name, a.data_ptr(), b, h, wd, cp, ho, wo, kh,
                    kw, sh, sw, ph, pw, w.data_ptr(), w.stride(0), n, scale, float(s_x),
                    bias_p, out.data_ptr(), ldc, hw, m_base, _OUT_KINDS[out_dtype], int(tiled),
                    p.bn, p.wgs, p.stages)
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
    m, n = a.shape[0], w.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    p = plan("bf16", m, n, _sms(a.device.index))
    _build.call(_entry(_GEMM), a.device, name, a.data_ptr(), a.stride(0) * 2, w.data_ptr(),
                w.stride(0) * 2, m, n, a.shape[1] * 2, _OPS["bf16"], None, 0.0, None,
                out.data_ptr(), n, 0, 0, _OUT_KINDS[out_dtype], p.bn, p.wgs, p.stages)
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
