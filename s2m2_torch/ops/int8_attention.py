"""The int8 attention core: kernel F.

The port of the JAX package's int8_attn opt-in (`sdpa_maybe_quantized`,
s2m2_tpu/models/quant.py:369-404, which XLA compiles there; it is no
Pallas kernel). For (B, N, D) sequences, each attending only within
itself, with static calibrated scales s_q, s_k, s_v:

- q, k, v quantized as every int8 site's input: clip(round(x * float32(1 /
  s)), -127, 127), round half to even;
- S = q_q k_q^T in int32, score = float(S) * float32(s_q s_k D^-1/2);
- a float32 softmax, pmax = the row max of attn, p_q = round(attn * (127 /
  pmax)) in int8 (the per-row dynamic scale of the probabilities);
- O = p_q v_q in int32, out = float(O) * (pmax * float32(s_v / 127)), cast
  to v's dtype.

On a CUDA tensor `int8_attention` launches `csrc/int8_attention.cu` (and
counts it in `_build.launch_counts["int8_attention"]`) or raises; on a CPU
tensor it runs `int8_attention_plain`, which follows JAX's order of
operations exactly, and is the kernel's oracle on the card. The kernel
uses pmax = 1 / l (l the row's sum of exponentials): p_q = round(127 exp(
score - max)), which can differ from the plain version's by one quantum
where 127 attn / pmax lies within float32 rounding of a half. While
torch.export traces, and on meta tensors, the wrapper calls the custom op
`s2m2_torch::int8_attention` (ops/library.py). F has no backward and
serves only: a call that autograd would record raises (ops/_grad.py).

`plan` picks the launch from the shape alone (the .cu's header note): with
one key tile (Nk <= 128) the fused route, one kernel that quantizes into
shared memory; else a quantize prologue and the wgmma attention kernel,
with its stages, and the workspace the wrapper takes from torch for the
int8 Q, K and V^T (one buffer a stream, kept at the largest size a call
there has needed).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ._grad import refuse_grad
from .int8_gemm import inv_scale

MAX_HEAD_DIM = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F = ctypes.c_float
_ENTRY = ("s2m2_int8_attention",
          (ctypes.c_void_p,) * 5 + (ctypes.c_longlong,) + (ctypes.c_int,) * 4 + (_F,) * 5
          + (ctypes.c_int,) * 2)

# the kernel's geometry (csrc/int8_attention.cu, whose `geometry` mirrors
# `plan`): 64 queries a unit (one warpgroup's wgmma rows), 128-key tiles
# (one 128-byte swizzle row of V^T), Q and K rows in 128-byte k tiles,
# output columns in chunks of at most 128 (P V^T's wgmma N; the plan's
# chunk width is one of `DCHS`, each a compiled instance)
BQ, BKEY, KTB = 64, 128, 128
DCHS = (32, 64, 96, 128)
MAX_SMEM = 232448  # shared bytes a block may use on the H100
MAX_STAGES = 6


class Plan(NamedTuple):
    """Kernel F's launch for one shape: its route, "fused" (one key tile:
    one launch that quantizes into shared memory; no stages, no
    workspace) or "tma" (the quantize prologue, then the attention kernel
    fed by TMA); DP, the head dim padded to 32 (int8 Q and K rows, V^T
    rows); NkP, the keys padded to 16 (V^T's row pitch); dtiles, the
    128-byte k tiles of a Q or K row; chunks of dch output columns (P V^T's
    wgmma N); qblocks of 64 queries and ktiles of 128 keys a sequence;
    stages of the K/V^T ring; the block's shared bytes; units, the grid (B
    x qblocks x chunks); and the workspace's byte offsets of K and V^T (Q
    at 0) and its size."""
    route: str
    dp: int
    nkp: int
    dtiles: int
    chunks: int
    dch: int
    qblocks: int
    ktiles: int
    stages: int
    smem: int
    units: int
    k_off: int
    v_off: int
    workspace: int


def _cdiv(a, b):
    return -(-a // b)


def _align(x):
    return _cdiv(x, 256) * 256


def _smem(dtiles, dch, stages):
    """Shared bytes of a block: 1024 of alignment, the Q tile, and the
    ring's stages (K tile and V^T chunk each) and barriers; with no stages
    (the fused route), one K tile and one V^T chunk."""
    if stages == 0:
        return 1024 + dtiles * (BQ + BKEY) * KTB + dch * BKEY
    return 1024 + dtiles * BQ * KTB + stages * (dtiles * BKEY * KTB + dch * BKEY) \
        + 16 * (stages + 1)


@functools.lru_cache(maxsize=None)
def plan(b, nq, nk, d, dtype) -> Plan:
    """Kernel F's plan for q (b, nq, d), k and v (b, nk, d) of `dtype`:
    the geometry above; with one key tile (nk <= 128) the fused route,
    else as many stages (2 to 6) as keep the block's shared memory within
    half the SM's (two blocks an SM), else within all of it. Raises on a
    shape the kernel does not take."""
    if dtype not in _DTYPES:
        raise TypeError(f"int8_attention: dtype {dtype} not supported (float32 or bfloat16)")
    if min(b, nq, nk, d) < 1 or d > MAX_HEAD_DIM:
        raise ValueError(f"int8_attention: no plan for q ({b}, {nq}, {d}), k ({b}, {nk}, {d})")
    dp = _cdiv(d, 32) * 32
    nkp = _cdiv(nk, 16) * 16
    dtiles = chunks = _cdiv(dp, KTB)
    dch = _cdiv(_cdiv(dp, chunks), 32) * 32
    qblocks, ktiles = _cdiv(nq, BQ), _cdiv(nk, BKEY)
    units = b * qblocks * chunks
    if ktiles == 1:
        return Plan("fused", dp, nkp, dtiles, chunks, dch, qblocks, ktiles, 0,
                    _smem(dtiles, dch, 0), units, 0, 0, 0)
    stages = 0
    for limit in (MAX_SMEM // 2, MAX_SMEM):
        fit = [s for s in range(2, MAX_STAGES + 1) if _smem(dtiles, dch, s) <= limit]
        if fit:
            stages = max(fit)
            break
    if not stages:
        raise ValueError(f"int8_attention: no room for two stages at d = {d}")
    k_off = _align(b * nq * dp)
    v_off = k_off + _align(b * nk * dp)
    return Plan("tma", dp, nkp, dtiles, chunks, dch, qblocks, ktiles, stages,
                _smem(dtiles, dch, stages), units, k_off, v_off, v_off + _align(b * dp * nkp))


def _wgmma_rs_struct(n):
    """The C++ specialization WgmmaRS<N>: one wgmma m64nNk32 s8 step with A
    from four registers of each thread (P) and B from a shared-memory
    descriptor (V^T), into N / 2 int32 accumulators, added to them (scale_d
    1) or overwriting them (scale_d 0)."""
    regs = n // 2
    outs = ", ".join(f"%{i}" for i in range(regs))
    cons = ", ".join(f'"+r"(d[{i}])' for i in range(regs))
    a = ", ".join(f"%{regs + i}" for i in range(4))
    return (f"template <> struct WgmmaRS<{n}> {{\n"
            f"  static __device__ __forceinline__ void mma(int (&d)[{regs}], int a0, int a1,"
            f" int a2, int a3, uint64_t b, int scale_d) {{\n"
            f'    asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 5}, 0;\\n"\n'
            f'                 "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 '
            f'{{{outs}}}, {{{a}}}, %{regs + 4}, p;\\n}}\\n"\n'
            f"                 : {cons}\n"
            f'                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d));\n'
            f"  }}\n}};\n")


def instances_header() -> str:
    """The C header csrc/int8_attention.cu includes from the build
    directory: the wgmma wrapper of S = Q K^T (m64n128k32, both operands in
    shared memory) and those of P V^T for each chunk width of `DCHS`, with
    the X-macro list S2M2_F_DCHS of the compiled chunk widths."""
    from .int8_gemm import _wgmma_struct
    lines = ["// Generated from s2m2_torch/ops/int8_attention.py.", "#pragma once",
             "#include <stdint.h>", "template <typename In, int BN> struct Wgmma;",
             "template <int N> struct WgmmaRS;", _wgmma_struct("int8", BKEY),
             *(_wgmma_rs_struct(n) for n in DCHS),
             f"#define S2M2_F_DCHS(X) {' '.join(f'X({n})' for n in DCHS)}"]
    return "\n".join(lines) + "\n"


def scales(s_q, s_k, s_v, d):
    """(inv_q, inv_k, inv_v, score scale, output scale) as float32 values:
    float32(1 / s) per input (as `ig.inv_scale`), float32(s_q s_k d^-1/2)
    and float32(s_v / 127), each product taken in double first as the JAX
    package's Python floats are."""
    return _scales(float(s_q), float(s_k), float(s_v), int(d))


@functools.lru_cache(maxsize=4096)
def _scales(s_q, s_k, s_v, d):
    f32 = np.float32
    return (inv_scale(s_q), inv_scale(s_k), inv_scale(s_v),
            float(f32(s_q * s_k * float(d) ** -0.5)), float(f32(s_v / 127.0)))


def _quantize(x, inv):
    q = torch.round(x.float() * torch.tensor(inv, dtype=torch.float32))
    return q.clamp(-127.0, 127.0)


def _plain(q, k, v, s_q, s_k, s_v):
    """(out, pmax): the plain version's output and each row's largest
    probability (B, Nq, 1), float32."""
    inv_q, inv_k, inv_v, c, out_scale = scales(s_q, s_k, s_v, q.shape[-1])
    f32 = torch.float32
    acc = torch.matmul(_quantize(q, inv_q).double(), _quantize(k, inv_k).double().transpose(-1, -2))
    score = acc.to(f32) * torch.tensor(c, dtype=f32)
    attn = torch.softmax(score, dim=-1)
    pmax = attn.amax(dim=-1, keepdim=True)
    p_q = torch.round(attn * (torch.tensor(127.0, dtype=f32) / pmax))
    o = torch.matmul(p_q.double(), _quantize(v, inv_v).double())
    return (o.to(f32) * (pmax * torch.tensor(out_scale, dtype=f32))).to(v.dtype), pmax


def int8_attention_plain(q, k, v, s_q, s_k, s_v):
    """The int8 attention core in JAX's order of operations (module
    docstring): q (B, Nq, D), k and v (B, Nk, D); returns (B, Nq, D) in v's
    dtype. The integer products are exact (float64 sums of int8 products)."""
    return _plain(q, k, v, s_q, s_k, s_v)[0]


# the share of output elements that may differ from the plain version by
# more than their rounding (`agreement`): a flipped quantum needs 127 e
# within float32 rounding of a half (at most 1.03e-4 of the elements at the
# S shapes on the H100), while a wrong scale or row max moves every element
MAX_FLIPPED_SHARE = 0.01


def agreement(got, q, k, v, s_q, s_k, s_v):
    """Kernel F's output `got` held to its plain version on the same inputs:
    {max_abs_err, flipped_share, bound, ok}. A probability quantum that
    flips (p_q one off where 127 attn / pmax lies within float32 rounding of
    a half) moves a row's output by |v_q| pmax s_v / 127 <= s_v pmax, pmax =
    1 / l the row's largest probability. So each element is held within two
    quanta of its own row, 2 s_v pmax_row, plus the rounding r (|ref| + 2
    s_v pmax_row): r = 2^-7 + 1e-5 in bf16 (one ulp, and the float32 sum l
    taken in another order), 1e-5 in float32. And at most
    MAX_FLIPPED_SHARE of the elements differ by more than r |ref|."""
    ref, pmax = _plain(q, k, v, s_q, s_k, s_v)
    quanta = 2 * float(s_v) * pmax.to(got.device)
    r = (2 ** -7 if got.dtype == torch.bfloat16 else 0.0) + 1e-5
    ref = ref.float().to(got.device)
    diff = (got.float() - ref).abs()
    limit = quanta + r * (ref.abs() + quanta)
    flipped = float((diff > r * ref.abs()).float().mean())
    return {"max_abs_err": float(diff.max()), "flipped_share": flipped,
            "bound": f"<= 2 s_v pmax_row + {r:g} (|ref| + 2 s_v pmax_row) (largest "
                     f"{float(limit.max()):.3e}); share over {r:g}|ref| <= "
                     f"{MAX_FLIPPED_SHARE:g}",
            "ok": bool((diff <= limit).all()) and flipped <= MAX_FLIPPED_SHARE}


def check(q, k, v):
    """Raise on inputs kernel F does not take."""
    dt = q.dtype
    if dt not in _DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"int8_attention: q, k, v must share a float32 or bfloat16 dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    qs, ks = q.shape, k.shape
    if len(qs) != 3 or len(ks) != 3 or ks != v.shape or qs[0] != ks[0] or qs[2] != ks[2]:
        raise ValueError(f"int8_attention: q (B, Nq, D), k and v (B, Nk, D), got "
                         f"{tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    if qs[2] > MAX_HEAD_DIM:
        raise ValueError(f"int8_attention: head dim {qs[2]} > {MAX_HEAD_DIM}")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("int8_attention: q, k, v on different devices")


def int8_attention(q, k, v, s_q, s_k, s_v):
    """Kernel F on CUDA tensors, its plain version on CPU tensors (module
    docstring): q (B, Nq, D), k and v (B, Nk, D) -> (B, Nq, D) in v's
    dtype."""
    check(q, k, v)
    if _build.via_op(q):
        return _build.op("int8_attention")(q, k, v, float(s_q), float(s_k), float(s_v))
    if q.device.type == "cpu":
        return int8_attention_plain(q, k, v, s_q, s_k, s_v)
    if q.device.type != "cuda":
        raise ValueError(f"int8_attention: unsupported device {q.device}")
    refuse_grad("int8_attention", q, k, v)
    return _kernel(q.contiguous(), k.contiguous(), v.contiguous(), s_q, s_k, s_v)


# (device index, stream) -> the largest workspace a call on that stream took:
# calls on one stream run in order, so each reuses it (one allocation, and
# the same addresses, whose tensor maps the kernel caches)
_WORKSPACES: dict = {}


def _workspace(device, nbytes):
    """`nbytes` of workspace for a launch on `device`'s current stream."""
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    work = _WORKSPACES.get(key)
    if work is None or work.numel() < nbytes:
        _WORKSPACES[key] = work = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return work


def _kernel(q, k, v, s_q, s_k, s_v):
    """Kernel F's direct launch on contiguous CUDA tensors, by `plan`."""
    b, nq, d = q.shape
    nk = k.shape[1]
    pl = plan(b, nq, nk, d, q.dtype)
    dev = q.device
    out = torch.empty_like(q)
    work = _workspace(dev, pl.workspace).data_ptr() if pl.workspace else 0
    _build.call(_build.entry("int8_attention", *_ENTRY), dev, "int8_attention",
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), work,
                pl.workspace, b, nq, nk, d, *scales(s_q, s_k, s_v, d), _DTYPES[q.dtype],
                pl.stages)
    return out
