"""Attention primitives and blocks (reference: src/s2m2/core/model/attentions.py).

All LayerNorms are affine-free pre-norms. Blocks take and return NCHW maps
and run their sublayers on channel-last tokens. Two families:

- scanline (1D) attention: every image row is an independent sequence, so
  rows fold into the batch axis: (B, C, H, W) -> (B*H, W, C) tokens;
- global (2D) attention over the H*W tokens of the 1/32 bottleneck, with the
  factorized sinc relative PE on the feature pyramid's encoder blocks and
  weight-shared bidirectional cross-view attention in the MRT.

Every attention without PE goes through `ops.flash_attention` (the CUDA
kernels on a card), or, for a scanline block with the fused route on,
through `ops.fused_block`. The PE branch needs the probability matrix
itself, so it stays matmul + softmax.

Inside an int8 context (`quant`), in the JAX package's site order
(`s2m2_tpu/models/attention.py`): q/k/v read one shared site, as do the
two branches of a conv block; a multi-head scanline block projects each
head's attention output through its own row slice of `proj` (one site per
head, summed in the compute dtype, as JAX's `_attn_4d_sliced`), with q, k,
v and proj quantized as whole weights; under "int8r" the first three
sublayers of a scanline block hand their output on as int8. The attention
cores stay float, and a fused block stays float and holds no site.
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers, quant
from .layers import Linear
from .pe import pe_contract
from ..ops import flash_attention as fa
from ..ops import fused_block as fb


def _fold_heads(x, num_heads):
    """(B, N, H*d) -> (B*H, N, d), contiguous."""
    b, n, e = x.shape
    d = e // num_heads
    # reshape may return a strided view (e.g. at b == 1): the kernels take
    # contiguous tensors
    return x.reshape(b, n, num_heads, d).transpose(1, 2).reshape(
        b * num_heads, n, d).contiguous()


def _head_weights(attn):
    """{name: prequantization} of q, k, v and proj: in a quant context the
    multi-head scanline blocks quantize them as whole weights before they
    are sliced per head (quant.prequantize_linear); otherwise None, and
    each module uses its own."""
    names = ("q", "k", "v", "proj")
    if attn.sliced and quant.active():
        return {n: quant.prequantize_linear(getattr(attn, n)) for n in names}
    return dict.fromkeys(names)


def _weight_cols(w_q, sl):
    """Columns `sl` of a prequantized (N, Kp) weight, zero-padded to a
    multiple of 32 when the slice is not one."""
    cols = w_q[:, sl]
    width = sl.stop - sl.start
    pad = (width + 31) // 32 * 32 - width
    return cols if pad == 0 else torch.nn.functional.pad(cols, (0, pad)).contiguous()


def _project(attn, out, qw):
    """attn.proj on the (B*H, N, d) head outputs: one GEMM on the merged
    heads, or, in a quant context of a multi-head scanline block, one site
    per head on its row slice of proj, summed in the compute dtype."""
    nh = attn.num_heads
    if not (attn.sliced and quant.active()):
        return attn.proj(_unfold_heads(out, nh), qw)
    bh, n, d = out.shape
    heads = out.view(bh // nh, nh, n, d)
    w = attn.proj.weight
    acc = None
    for h in range(nh):
        sl = slice(h * d, (h + 1) * d)
        qwh = None if qw is None else (_weight_cols(qw[0], sl), qw[1])
        y = layers.linear_q(heads[:, h], w[:, sl], None, qwh)
        acc = y if acc is None else acc + y
    if attn.proj.bias is not None:
        acc = acc + attn.proj.bias.to(acc.dtype)
    return acc


def _unfold_heads(x, num_heads):
    """(B*H, N, d) -> (B, N, H*d)."""
    if num_heads == 1:
        return x
    bh, n, d = x.shape
    return x.reshape(bh // num_heads, num_heads, n, d).transpose(1, 2).reshape(
        bh // num_heads, n, num_heads * d)


class SelfAttn(nn.Module):
    """Multi-head self attention on (B, N, C) tokens (reference: attentions.py:8-54)."""

    def __init__(self, d, num_heads, e=1, use_pe=False, pe_dim=32):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(d, e * d, bias=False)
        self.k = Linear(d, e * d, bias=False)
        self.v = Linear(d, e * d)
        self.proj = Linear(e * d, d, bias=False)
        self.sliced = False  # per-head proj sites (multi-head scanline blocks)
        if use_pe:
            self.pe_proj = Linear(pe_dim, e * d // num_heads)

    def forward(self, x, pe=None):
        """pe: None, or (ty, tx, h, w), the factorized relative-PE context."""
        nh = self.num_heads
        x = quant.share_gemm_input(x)
        qw = _head_weights(self)
        q = _fold_heads(self.q(x, qw["q"]), nh)
        k = _fold_heads(self.k(x, qw["k"]), nh)
        v = _fold_heads(self.v(x, qw["v"]), nh)
        if pe is None:
            out = fa.scanline_attention(q, k, v)
        else:
            ty, tx, h, w = pe
            scale = q.shape[-1] ** -0.5
            score = torch.matmul(q * scale, k.transpose(-1, -2))
            attn = torch.softmax(score.float(), dim=-1).to(v.dtype)
            out = torch.matmul(attn, v)
            pe_sum = pe_contract(attn, ty, tx, h, w).to(v.dtype)
            out = out + self.pe_proj(pe_sum)
        return _project(self, out, qw["proj"])


class CrossAttn(nn.Module):
    """Symmetric weight-shared bidirectional cross attention on the packed
    (left | right) batch (reference: attentions.py:57-96). The views share
    Q/K/V weights, so each projection runs once on both views."""

    def __init__(self, d, num_heads, e=1):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(d, e * d, bias=False)
        self.k = Linear(d, e * d, bias=False)
        self.v = Linear(d, e * d)
        self.proj = Linear(e * d, d, bias=False)
        self.sliced = False  # per-head proj sites (multi-head scanline blocks)

    def forward(self, xy):
        """xy: (2*b0, N, C), left view first on the batch axis."""
        nh = self.num_heads
        xy = quant.share_gemm_input(xy)
        qw = _head_weights(self)
        q = _fold_heads(self.q(xy, qw["q"]), nh)
        k = _fold_heads(self.k(xy, qw["k"]), nh)
        v = _fold_heads(self.v(xy, qw["v"]), nh)
        # the left view's rows come first after folding; one output tensor
        return _project(self, fa.scanline_cross_attention_packed(q, k, v), qw["proj"])


class FFN(nn.Module):
    """Pre-norm MLP with exact GELU and a residual (reference: attentions.py:229-250)."""

    def __init__(self, d, e=1):
        super().__init__()
        self.ffn = nn.Sequential(Linear(d, e * d), nn.GELU(), Linear(e * d, d))

    def forward(self, z):
        z = quant.residual_load(z)
        return self.ffn(layers.layer_norm(z)) + z


class SelfAttnBlock(nn.Module):
    """Pre-norm self attention + residual on (B, N, C) tokens."""

    def __init__(self, d, num_heads, e=1, use_pe=False):
        super().__init__()
        self.attn = SelfAttn(d, num_heads, e, use_pe)

    def forward(self, z, pe=None):
        z = quant.residual_load(z)
        return self.attn(layers.layer_norm(z), pe) + z


class CrossAttnBlock(nn.Module):
    """Pre-norm bidirectional cross attention + residual on packed tokens."""

    def __init__(self, d, num_heads, e=1):
        super().__init__()
        self.attn = CrossAttn(d, num_heads, e)

    def forward(self, z):
        z = quant.residual_load(z)
        return self.attn(layers.layer_norm(z)) + z


def _rows(z):
    """(B, C, H, W) -> (B*H, W, C) scanline tokens."""
    b, c, h, w = z.shape
    return z.permute(0, 2, 3, 1).reshape(b * h, w, c)


def _unrows(t, b, h):
    bh, w, c = t.shape
    return t.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous()


class BasicAttnBlock(nn.Module):
    """Scanline cross + FFN + self + FFN (reference: attentions.py:324-355).
    z: (2B, C, H, W), left view first on the batch axis.

    With `fused` set (by `MRT.set_fused_block`), the whole block is one call
    of `ops.fused_block` (kernel D on a card); otherwise each sublayer runs
    on its own, its attentions through kernels A and B."""

    def __init__(self, d, num_heads, e=1):
        super().__init__()
        self.num_heads = num_heads
        self.fused = False
        self.cross_attn = CrossAttnBlock(d, num_heads, e)
        self.self_attn = SelfAttnBlock(d, num_heads, e)
        self.ffn_c = FFN(d, e)
        self.ffn = FFN(d, e)
        self.cross_attn.attn.sliced = self.self_attn.attn.sliced = num_heads > 1

    def fused_weights(self):
        """The 18 weights in the fused kernel's order, as the modules hold them."""
        c, s = self.cross_attn.attn, self.self_attn.attn
        f1, f2 = self.ffn_c.ffn, self.ffn.ffn
        return [c.q.weight, c.k.weight, c.v.weight, c.v.bias, c.proj.weight,
                f1[0].weight, f1[0].bias, f1[2].weight, f1[2].bias,
                s.q.weight, s.k.weight, s.v.weight, s.v.bias, s.proj.weight,
                f2[0].weight, f2[0].bias, f2[2].weight, f2[2].bias]

    def forward_rows(self, t):
        """The block on (2*B*H, W, C) scanline tokens, left view first. The
        fused route stays float in a quant context (no site); under int8r
        the first three sublayers hand their output on as int8."""
        if self.fused:
            return fb.fused_basic_attn_block(t, t.shape[0] // 2, self.fused_weights(),
                                             self.num_heads)
        t = quant.residual_store(self.cross_attn(t))
        t = quant.residual_store(self.ffn_c(t))
        t = quant.residual_store(self.self_attn(t))
        return self.ffn(t)

    def forward(self, z):
        b, _, h, _ = z.shape
        return _unrows(self.forward_rows(_rows(z)), b, h)


class GlobalAttnBlock(nn.Module):
    """[cross + FFN] + self + FFN over the H*W tokens of a 2D map
    (reference: attentions.py:284-321)."""

    def __init__(self, d, num_heads, e=1, use_cross_attn=False, use_pe=False):
        super().__init__()
        self.self_attn = SelfAttnBlock(d, num_heads, e, use_pe)
        self.ffn = FFN(d, e)
        if use_cross_attn:
            self.cross_attn = CrossAttnBlock(d, num_heads, e)
            self.ffn_c = FFN(d, e)

    def forward(self, z, pe=None):
        """pe: None, or the (ty, tx) per-axis tables of `pe.pe_tables`."""
        b, c, h, w = z.shape
        t = z.permute(0, 2, 3, 1).reshape(b, h * w, c)
        if hasattr(self, "cross_attn"):
            t = self.ffn_c(self.cross_attn(t))
        t = self.self_attn(t, None if pe is None else (pe[0], pe[1], h, w))
        t = self.ffn(t)
        return t.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous()


class ConvBlock2D(nn.Module):
    """3x3 MLP-conv + 1x1 MLP-conv, summed, no residual (reference:
    attentions.py:255-281)."""

    def __init__(self, d, e=1, k=3):
        super().__init__()
        self.convs = layers.mlp2(d, e * d, d, k, k)
        self.convs_1x = layers.mlp2(d, e * d, d, 1, 1, act=nn.ReLU)

    def forward(self, z):
        z = quant.share_gemm_input(z)  # both branches read one int8 site
        return self.convs(z) + self.convs_1x(z)
