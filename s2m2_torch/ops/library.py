"""Kernels A-F as `torch.library` custom ops, namespace `s2m2_torch`.

The wrappers launch their CUDA kernels through ctypes on `data_ptr()`
(`_build.call`), which tracing cannot see: `torch.export` would either
inline a plain version (CPU example inputs) or fail on fake tensors (CUDA
or meta ones). Each kernel entry the model calls is therefore also a
registered op, and the wrappers call it while `torch.export` traces and
for meta tensors (`_build.via_op`), so an exported program holds one
`torch.ops.s2m2_torch.*` call per kernel launch, and running it launches
the hand-written kernels:

- `scanline_attention(q, k, v)`: kernel A;
- `scanline_cross_attention_packed(q, k, v)`: kernel B on the packed
  (x | y) batch;
- `fused_correlation_ot(f0, f1, ot_iter, use_positivity) -> (prob, cv)`:
  kernel C;
- `fused_basic_attn_block(rows, right0, weights, num_heads)`: kernel D;
- `int8_quantize_pack(x, inv, conv, rows, nhwc)` and `int8_gemm(a, w,
  w_scale, s_x, bias, out_dtype, conv, nchw, acc_bf16)`: kernel E's two
  launches;
- `int8_attention(q, k, v, s_q, s_k, s_v)`: kernel F, the int8 attention
  core of the int8_attn opt-in;
- `conv_tf32x3(x, w_split, bias, kh, kw, ph, pw)`: kernel G, a float32
  spatial conv by split TF32 (the weight split by `conv.split_weight`,
  which an exported program computes from the parameter in its graph).

Per device: the "cuda" kernel of each op is the wrapper's direct launch
(the same `_build.call`, counted in `_build.launch_counts`, raising on a
build or launch error); the "cpu" kernel is the plain version; the fake
implementation (also the meta kernel) computes only the output's shape
and dtype, from the checks the wrapper makes, and touches no device; any
other device raises. The CUDA kernels read dense rows, and the wrappers
make their inputs so before they call an op (`.contiguous()`). But an
exported program runs each node's real kernel, whose output can have other
strides than the fake tensor the trace saw, and then the trace recorded no
copy (an int8 program's stem im2col input on the H100): so each "cuda"
kernel copies an input the launch cannot read (`_dense`), a no-op for every
call the wrappers make directly.

The int8 GEMM op is functional: it returns a new tensor, (M, N) rows or,
with `nchw`, the NCHW output the kernel writes directly. A call the model
makes in chunks of an NCHW output (explicit im2col rows of more than
`models.quant.MAX_PACK_BYTES`) gets each chunk's rows back and copies them
into the output (`int8_gemm`'s `out`). An op that mutated `out` in place
would be wrapped by export in `auto_functionalized`, which clones the whole
output for every chunk when the program runs.

No op registers a gradient: exported programs serve. Training keeps the
wrappers' autograd Functions for A, B and C; D and E raise under grad.
Loading an exported program needs this module imported (it registers the
ops) and nothing of `s2m2_torch.models`.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import Tensor

from . import conv
from . import flash_attention as fa
from . import fused_block as fb
from . import int8_attention as ia
from . import int8_gemm as ig
from . import sinkhorn

NAMESPACE = "s2m2_torch"


def _dense(t):
    return t.contiguous()


def _rows(x):
    """Token rows as the pack kernel reads them: contiguous, or a (b, n, K)
    view with a contiguous last axis (`ig._token_rows`)."""
    return x if x.is_contiguous() or (x.dim() == 3 and x.stride(2) == 1) else x.contiguous()


def _unsupported(name, t):
    return ValueError(f"{NAMESPACE}::{name}: unsupported device {t.device} "
                      "(cuda or cpu)")


# ---------------------------------------------------------------- A


@torch.library.custom_op(f"{NAMESPACE}::scanline_attention", mutates_args=())
def scanline_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    raise _unsupported("scanline_attention", q)


@scanline_attention.register_kernel("cuda")
def _(q, k, v):
    return fa._attention_kernel(_dense(q), _dense(k), _dense(v))


@scanline_attention.register_kernel("cpu")
def _(q, k, v):
    return fa.scanline_attention_plain(q, k, v)


@scanline_attention.register_fake
def _(q, k, v):
    fa._check((q, k, v))
    return q.new_empty(q.shape)


# ---------------------------------------------------------------- B


@torch.library.custom_op(f"{NAMESPACE}::scanline_cross_attention_packed", mutates_args=())
def scanline_cross_attention_packed(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    raise _unsupported("scanline_cross_attention_packed", q)


@scanline_cross_attention_packed.register_kernel("cuda")
def _(q, k, v):
    return fa._cross_kernel(_dense(q), _dense(k), _dense(v))


@scanline_cross_attention_packed.register_kernel("cpu")
def _(q, k, v):
    return fa.packed_cross_attention_plain(q, k, v)


@scanline_cross_attention_packed.register_fake
def _(q, k, v):
    fa._check_packed((q, k, v))
    return q.new_empty(q.shape)


# ---------------------------------------------------------------- C


@torch.library.custom_op(f"{NAMESPACE}::fused_correlation_ot", mutates_args=())
def fused_correlation_ot(f0: Tensor, f1: Tensor, ot_iter: int,
                         use_positivity: bool) -> Tuple[Tensor, Tensor]:
    raise _unsupported("fused_correlation_ot", f0)


@fused_correlation_ot.register_kernel("cuda")
def _(f0, f1, ot_iter, use_positivity):
    return sinkhorn._ot_kernel(_dense(f0), _dense(f1), ot_iter, use_positivity)


@fused_correlation_ot.register_kernel("cpu")
def _(f0, f1, ot_iter, use_positivity):
    return sinkhorn.fused_correlation_ot_plain(f0, f1, ot_iter, use_positivity)


@fused_correlation_ot.register_fake
def _(f0, f1, ot_iter, use_positivity):
    sinkhorn.check(f0, f1)
    b, h, w, _ = f0.shape
    return f0.new_empty((b, h, w, w)), f0.new_empty((b, h, w, w))


# ---------------------------------------------------------------- D


@torch.library.custom_op(f"{NAMESPACE}::fused_basic_attn_block", mutates_args=())
def fused_basic_attn_block(rows: Tensor, right0: int, weights: List[Tensor],
                           num_heads: int) -> Tensor:
    raise _unsupported("fused_basic_attn_block", rows)


@fused_basic_attn_block.register_kernel("cuda")
def _(rows, right0, weights, num_heads):
    rows, weights = _dense(rows), [_dense(t) for t in weights]
    e = fb._check(rows, right0, weights, num_heads)
    return fb._launch(rows, right0, weights, num_heads, e)


@fused_basic_attn_block.register_kernel("cpu")
def _(rows, right0, weights, num_heads):
    rows, weights = _dense(rows), [_dense(t) for t in weights]
    fb._check(rows, right0, weights, num_heads)
    return torch.cat(fb.fused_basic_attn_block_plain(rows[:right0], rows[right0:], weights,
                                                     num_heads))


@fused_basic_attn_block.register_fake
def _(rows, right0, weights, num_heads):
    fb._check(rows, right0, weights, num_heads)
    return rows.new_empty(rows.shape)


# ---------------------------------------------------------------- E


@torch.library.custom_op(f"{NAMESPACE}::int8_quantize_pack", mutates_args=())
def int8_quantize_pack(x: Tensor, inv: float, conv: Optional[List[int]],
                       rows: Optional[List[int]], nhwc: bool) -> Tensor:
    raise _unsupported("int8_quantize_pack", x)


@int8_quantize_pack.register_kernel("cuda")
def _(x, inv, conv, rows, nhwc):
    x = _rows(x) if conv is None and not nhwc else _dense(x)
    return ig._pack_kernel(x, inv, conv, rows, nhwc)


@int8_quantize_pack.register_kernel("cpu")
def _(x, inv, conv, rows, nhwc):
    return ig.quantize_pack_plain(x, inv, conv, rows, nhwc)


@int8_quantize_pack.register_fake
def _(x, inv, conv, rows, nhwc):
    return x.new_empty(ig.pack_shape(x, conv, rows, nhwc), dtype=torch.int8)


@torch.library.custom_op(f"{NAMESPACE}::int8_gemm", mutates_args=())
def int8_gemm(a: Tensor, w: Tensor, w_scale: Optional[Tensor], s_x: float,
              bias: Optional[Tensor], out_dtype: torch.dtype, conv: Optional[List[int]],
              nchw: Optional[List[int]], acc_bf16: bool = False) -> Tensor:
    raise _unsupported("int8_gemm", a)


@int8_gemm.register_kernel("cuda")
def _(a, w, w_scale, s_x, bias, out_dtype, conv, nchw, acc_bf16=False):
    a, w = _dense(a), _dense(w)
    a, conv, m, n, _ = ig.gemm_geometry(a, w, w_scale, out_dtype, conv, nchw)
    return ig._gemm_kernel(a, w, w_scale, s_x, bias, out_dtype, None, 0, conv, m, n, nchw,
                           acc_bf16)


@int8_gemm.register_kernel("cpu")
def _(a, w, w_scale, s_x, bias, out_dtype, conv, nchw, acc_bf16=False):
    a, conv, _, _, _ = ig.gemm_geometry(a, w, w_scale, out_dtype, conv, nchw)
    y = ig.int8_gemm_plain(a, w, w_scale, s_x, bias, out_dtype, conv, acc_bf16)
    return y if nchw is None else ig._rows_to_nchw(y, nchw)


@int8_gemm.register_fake
def _(a, w, w_scale, s_x, bias, out_dtype, conv, nchw, acc_bf16=False):
    shape = ig.gemm_geometry(a, w, w_scale, out_dtype, conv, nchw)[4]
    return a.new_empty(shape, dtype=out_dtype)


# ---------------------------------------------------------------- F


@torch.library.custom_op(f"{NAMESPACE}::int8_attention", mutates_args=())
def int8_attention(q: Tensor, k: Tensor, v: Tensor, s_q: float, s_k: float,
                   s_v: float) -> Tensor:
    raise _unsupported("int8_attention", q)


@int8_attention.register_kernel("cuda")
def _(q, k, v, s_q, s_k, s_v):
    return ia._kernel(_dense(q), _dense(k), _dense(v), s_q, s_k, s_v)


@int8_attention.register_kernel("cpu")
def _(q, k, v, s_q, s_k, s_v):
    return ia.int8_attention_plain(q, k, v, s_q, s_k, s_v)


@int8_attention.register_fake
def _(q, k, v, s_q, s_k, s_v):
    ia.check(q, k, v)
    return v.new_empty(q.shape)


# ---------------------------------------------------------------- G


@torch.library.custom_op(f"{NAMESPACE}::conv_tf32x3", mutates_args=())
def conv_tf32x3(x: Tensor, w_split: Tensor, bias: Optional[Tensor], kh: int, kw: int,
                ph: int, pw: int) -> Tensor:
    raise _unsupported("conv_tf32x3", x)


@conv_tf32x3.register_kernel("cuda")
def _(x, w_split, bias, kh, kw, ph, pw):
    return conv._kernel(_dense(x), _dense(w_split), bias, kh, kw, ph, pw)


@conv_tf32x3.register_kernel("cpu")
def _(x, w_split, bias, kh, kw, ph, pw):
    return conv.conv_tf32x3_plain(x, w_split, bias, kh, kw, ph, pw)


@conv_tf32x3.register_fake
def _(x, w_split, bias, kh, kw, ph, pw):
    conv._check(x, w_split, bias, kh, kw, ph, pw)
    return x.new_empty(conv.out_shape(x, w_split, kh, kw, ph, pw))
