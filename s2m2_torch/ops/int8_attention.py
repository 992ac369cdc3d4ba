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
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from ._grad import refuse_grad
from .int8_gemm import inv_scale

MAX_HEAD_DIM = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F = ctypes.c_float
_ENTRY = ("s2m2_int8_attention",
          (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (_F,) * 5 + (ctypes.c_int,))


def scales(s_q, s_k, s_v, d):
    """(inv_q, inv_k, inv_v, score scale, output scale) as float32 values:
    float32(1 / s) per input (as `ig.inv_scale`), float32(s_q s_k d^-1/2)
    and float32(s_v / 127), each product taken in double first as the JAX
    package's Python floats are."""
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
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"int8_attention: q, k, v must share a float32 or bfloat16 dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise ValueError(f"int8_attention: q (B, Nq, D), k and v (B, Nk, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] > MAX_HEAD_DIM:
        raise ValueError(f"int8_attention: head dim {q.shape[2]} > {MAX_HEAD_DIM}")
    if not (q.device == k.device == v.device):
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


def _kernel(q, k, v, s_q, s_k, s_v):
    """Kernel F's direct launch on contiguous CUDA tensors."""
    b, nq, d = q.shape
    out = torch.empty_like(q)
    _build.call(_build.entry("int8_attention", *_ENTRY), q.device, "int8_attention",
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq, k.shape[1],
                d, *scales(s_q, s_k, s_v, d), _DTYPES[q.dtype])
    return out
