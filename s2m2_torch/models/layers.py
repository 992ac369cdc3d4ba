"""Core NCHW layer primitives and the parameter-holding modules built on them.

Layouts are PyTorch's: activations NCHW, conv weights OIHW, transposed-conv
weights (I, O, kh, kw), linear weights (out, in). Numerics follow
`s2m2_tpu.models.layers`:

- normalization statistics run in float32 whatever the compute dtype;
- the fp32-island rule: a float32 weight meeting a bfloat16 input upcasts the
  input, so the layer computes and returns float32 (the engine keeps a few
  precision-critical heads in float32, see runtime/engine.py);
- inside an int8 context (`quant.observe` / `quant.quantized`) the Conv and
  Linear modules are sites (JAX `layers.py:67-79`, `:125-134`): the int8
  path adds the bias in float32 and casts to the input's dtype, and a
  prequantized weight on the float path is dequantized. A ConvT is a site
  only where `site_gate` is set (the mask heads, which the JAX package
  runs as packed convolutions);
- under band sharding (`parallel.band.sharded`) the primitives that read
  across rows take their neighbours' rows first: a conv (and a stride-1
  ConvT) the rows its band's first and last outputs read, then convolves
  with row padding 0; bilinear x2 and the 3x3 unfold one row each side,
  replicated only at the image's edges; GroupNorm sums its statistics over
  the bands. Everything else is row-local. With no band context the code
  is the one-device code;
- on the float path a Conv whose input is float32 on the card, with no
  gradient wanted and stride 1 runs on kernel G (`ops.conv.route`: split
  TF32 on the tensor cores, float32 accuracy; a 1x1 kernel on G's flat
  path) where `ops.conv.plan` takes the shape; every other conv is
  F.conv2d.
  The split weight G reads is made on first use and kept on the module
  until the weight changes (`Conv.g_weight`). Each float32 CUDA conv adds
  its operations to the counter `conv.own_flops` (G) or
  `conv.library_flops` (cuDNN).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import quant
from ..ops import conv as conv_g
from ..parallel import band
from ..runtime import trace


def _operands(x, weight, bias):
    """Apply the fp32-island rule and bring weight and bias to x's dtype."""
    if weight.dtype == torch.float32 and x.dtype == torch.bfloat16:
        x = x.float()
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    return x, w, b


def conv2d(x, weight, bias=None, stride=1, padding=None):
    """torch Conv2d with the reference padding convention k//2 per side."""
    if padding is None:
        padding = (weight.shape[-2] // 2, weight.shape[-1] // 2)
    x, w, b = _operands(x, weight, bias)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv_transpose2d(x, weight, bias=None, stride=1, padding=0):
    """torch ConvTranspose2d; weight (I, O, kh, kw)."""
    x, w, b = _operands(x, weight, bias)
    return F.conv_transpose2d(x, w, b, stride=stride, padding=padding)


def linear(x, weight, bias=None):
    """Dense layer on the trailing axis; weight (out, in)."""
    x, w, b = _operands(x, weight, bias)
    return F.linear(x, w, b)


def linear_q(x, weight, bias=None, qw=None):
    """`linear` with the int8 site hook. qw: the weight's prequantization
    (w_q, s_w), or None; x may be a `quant.SharedQuantInput`."""
    if quant.active():
        k = weight.shape[1]
        y = quant.gemm_site(x, weight, bias, qw, (k, k, weight.shape[0]))
        if y is not None:
            return y
    x = quant.unwrap(x)
    if qw is not None:  # a prequantized weight on the float path: dequantize
        weight = quant.dequantize(qw, weight.shape[1], x.dtype)
    return linear(x, weight, bias)


def gelu(x):
    """Exact (erf) GELU, torch nn.GELU() default."""
    return F.gelu(x)


def layer_norm(x, weight=None, bias=None, eps=1e-5):
    """LayerNorm over the last axis with float32 statistics; affine-free when
    weight is None (the reference's elementwise_affine=False norms)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def group_norm(x, weight, bias, num_groups=8, eps=1e-5):
    """GroupNorm over NCHW with two-pass float32 statistics.

    The one-pass E[x^2]-mean^2 form loses to cancellation when |mean| >> std;
    the affine is folded into per-group (a, d) coefficients as the JAX
    package does, so both packages round alike. Under band sharding the two
    passes are two all-reduces over the bands: sums and count, then the
    squared deviations."""
    b, c, h, w = x.shape
    g = num_groups
    xf = x.float().reshape(b, g, c // g, h, w)
    if band.active():
        n = torch.tensor([float(c // g * h * w)], device=x.device)
        tot = band.all_reduce_sum(torch.cat([xf.sum(dim=(2, 3, 4)).reshape(-1), n]))
        count = tot[-1]
        mean = (tot[:-1] / count).reshape(b, g, 1, 1, 1)
        sq = band.all_reduce_sum((xf - mean).square().sum(dim=(2, 3, 4)).reshape(-1))
        var = (sq / count).reshape(b, g, 1, 1, 1)
    else:
        mean = xf.mean(dim=(2, 3, 4), keepdim=True)
        var = (xf - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    scale = torch.rsqrt(var + eps)
    a = scale * weight.float().reshape(1, g, c // g, 1, 1)
    d = bias.float().reshape(1, g, c // g, 1, 1) - mean * a
    return (xf * a + d).reshape(b, c, h, w).to(x.dtype)


def avg_pool2d(x, k=2):
    """Non-overlapping average pooling (torch nn.AvgPool2d(k))."""
    return F.avg_pool2d(x, k)


def upsample2x_bilinear(x):
    """Bilinear x2 upsample, half-pixel centers (align_corners=False). A call
    autograd records goes through `_Upsample2xBilinear`, whose backward is
    deterministic."""
    if band.active():
        return _band_bilinear2x(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Upsample2xBilinear.apply(x)
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def _band_bilinear2x(x):
    """Bilinear x2 of a band: one row of each neighbour (the edge row at the
    image's edges, which is the clamp), upsampled, less the two rows each
    side that the halo rows produce."""
    y = F.interpolate(band.halo(x, 1, 1, "edge"), scale_factor=2, mode="bilinear",
                      align_corners=False)
    return y[..., 2:-2, :]


def _stencil2x(n, device):
    """(2n, n) float32 matrix of the 1D bilinear x2 upsample with half-pixel
    centers and edge clamping: out[2i] = x[i-1]/4 + 3x[i]/4, out[2i+1] =
    3x[i]/4 + x[i+1]/4."""
    i = torch.arange(n)
    m = torch.zeros(2 * n, n)
    m.index_put_((2 * i, i), torch.full((n,), 0.75))
    m.index_put_((2 * i, (i - 1).clamp(min=0)), torch.full((n,), 0.25), accumulate=True)
    m.index_put_((2 * i + 1, i), torch.full((n,), 0.75))
    m.index_put_((2 * i + 1, (i + 1).clamp(max=n - 1)), torch.full((n,), 0.25),
                 accumulate=True)
    return m.to(device)


class _Upsample2xBilinear(torch.autograd.Function):
    """F.interpolate's bilinear x2 forward; the backward is the transposed
    stencil as two float32 matrix products. torch's CUDA backward of
    bilinear interpolation adds with atomics, so its bits vary from run to
    run and `torch.use_deterministic_algorithms` refuses it; this one gives
    a training step that repeats to the bit."""

    @staticmethod
    def forward(ctx, x):
        ctx.hw = x.shape[-2:]
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)

    @staticmethod
    def backward(ctx, grad):
        h, w = ctx.hw
        g = torch.matmul(grad.float(), _stencil2x(w, grad.device))       # (.., 2h, w)
        return torch.matmul(_stencil2x(h, grad.device).t(), g).to(grad.dtype)


def upsample_nearest(x, factor):
    """Integer-factor nearest upsample of the two trailing (spatial) axes."""
    return x.repeat_interleave(factor, dim=-2).repeat_interleave(factor, dim=-1)


def replicate_pad(x, pad=1):
    """Edge-replicate spatial padding of an NCHW tensor."""
    return F.pad(x, (pad, pad, pad, pad), mode="replicate")


def unfold9(x, pad=1):
    """3x3 neighborhood unfold as 9 shifted slices with replicate padding
    (reference: core/model/utils.py:9-20). Output channels are tap-major:
    out[:, t*C:(t+1)*C] is tap (di, dj) with t = di*3 + dj. Under band
    sharding the rows come from the neighbouring bands, replicated only at
    the image's edges."""
    h, w = x.shape[-2:]
    if band.active():
        xp = F.pad(band.halo(x, pad, pad, "edge"), (pad, pad, 0, 0), mode="replicate")
    else:
        xp = replicate_pad(x, pad)
    return torch.cat([xp[..., i:i + h, j:j + w] for i in range(3) for j in range(3)],
                     dim=1)


def logit(x, eps):
    """torch.logit(x, eps) in float32: clamp to [eps, 1-eps], log(p/(1-p))."""
    xf = x.float().clamp(eps, 1.0 - eps)
    return torch.log(xf / (1.0 - xf)).to(x.dtype)


def logsumexp_stable(x, dim, keepdim=False, eps=1e-30):
    """Max-shifted log-sum-exp with a clamped sum (reference:
    submodules.py:147-152)."""
    m = x.amax(dim=dim, keepdim=True)
    y = torch.exp(x - m).sum(dim=dim, keepdim=True)
    y = m + torch.log(y.clamp(min=eps))
    return y if keepdim else y.squeeze(dim)


# --------------------------------------------------------------------------
# Parameter-holding modules. Parameters are allocated uninitialized: every
# model is filled from `models.init.init_params` or a checkpoint.
# --------------------------------------------------------------------------

def _pair(k):
    return (k, k) if isinstance(k, int) else tuple(k)


def conv_halo_rows(kh, sh, ph):
    """(top, bottom): the rows above and below its band that a conv's band
    reads (band starts are multiples of the stride, as whole 32-row blocks
    guarantee): the first output reads ph rows up, the last kh - ph - sh
    rows down. With them and row padding 0 the band's outputs are its own."""
    return ph, max(0, kh - ph - sh)


def halo(x, top, bottom):
    """`band.halo` with zero fill, for a tensor or a quant.SharedQuantInput
    (whose scale the extended input keeps)."""
    if isinstance(x, quant.SharedQuantInput):
        return quant.SharedQuantInput(band.halo(x.x, top, bottom), x.scale)
    return band.halo(x, top, bottom)


class Conv(nn.Module):
    """Conv2d with fixed stride/padding (padding k//2 unless given).

    site_gate: the (k_in, cin, cout) shape that decides whether this conv is
    an int8 site, where the JAX package runs it in a packed form of another
    shape; None: its own (kh * kw * cin, cin, cout)."""

    int8_prequantizable = True

    def __init__(self, cin, cout, k, stride=1, padding=None, bias=True):
        super().__init__()
        kh, kw = _pair(k)
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride = stride
        self.padding = padding
        self.site_gate = None
        self._g_weight = None  # ((data_ptr, version), split weight) for kernel G

    def pads(self):
        """(ph, pw): the padding, k // 2 per side unless given."""
        kh, kw = self.weight.shape[2:]
        if self.padding is None:
            return kh // 2, kw // 2
        return _pair(self.padding)

    def forward(self, x, haloed=False):
        """haloed: under band sharding, x already carries the halo rows this
        conv reads (ConvBlock2D exchanges once for both its branches)."""
        ph, pw = self.pads()
        kh = self.weight.shape[2]
        if band.active() and kh > 1:
            if not haloed:
                x = halo(x, *conv_halo_rows(kh, self.stride, ph))
            ph = 0
        if quant.active():
            y = quant.conv_maybe_quantized(x, self, (ph, pw))
            if y is not None:
                return y
        x = quant.unwrap(x)
        w = self.weight
        qw = quant.prequant_of(self)
        if qw is not None:  # a prequantized weight on the float path: dequantize
            w = quant.dequantize(qw, w.shape[1:].numel(), x.dtype).reshape(w.shape)
            own = False
        else:
            own = conv_g.route(x, w, self.stride, (ph, pw)) is not None
        if own:
            kh, kw = w.shape[2:]
            y = conv_g.conv_tf32x3(x, self.g_weight(), self.bias, kh, kw, ph, pw)
        else:
            y = conv2d(x, w, self.bias, self.stride, (ph, pw))
        if y.is_cuda and y.dtype == torch.float32:
            trace.count("conv.own_flops" if own else "conv.library_flops",
                        conv_g.conv_flops(y, w))
        return y

    def g_weight(self):
        """The weight split for kernel G (`ops.conv.split_weight`), made on
        first use and kept until the weight's storage or version changes
        (an optimizer step, a load_state_dict, any in-place update). While
        torch.export traces, it is made in the traced graph instead; a
        weight made in inference mode has no version counter, so it is
        split on every call."""
        w = self.weight
        if torch.compiler.is_exporting() or w.is_inference():
            return conv_g.split_weight(w)
        key = (w.data_ptr(), w._version)
        if self._g_weight is None or self._g_weight[0] != key:
            with torch.no_grad():
                self._g_weight = (key, conv_g.split_weight(w.detach()))
        return self._g_weight[1]


class ConvT(nn.Module):
    """ConvTranspose2d with weight (I, O, kh, kw). An int8 site only where
    `site_gate` is set (see `quant.conv_transpose_maybe_quantized`)."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True):
        super().__init__()
        kh, kw = _pair(k)
        self.weight = nn.Parameter(torch.empty(cin, cout, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride = stride
        self.padding = padding
        self.site_gate = None

    def forward(self, x):
        """Under band sharding a stride-1 ConvT (a conv with the flipped
        kernel and padding kh - 1 - p) takes kh - 1 - p rows from above and p
        from below, then crops kh - 1 rows each side of its full output; a
        ConvT whose stride equals its kernel (padding 0) is row-local."""
        kh, kw = self.weight.shape[2:]
        p, row_pad = self.padding, None
        if band.active() and kh > 1:
            if self.stride != 1 and not (self.stride == kh and p == 0):
                raise NotImplementedError(f"band-sharded ConvT: stride {self.stride}, "
                                          f"kernel {kh}, padding {p}")
            if self.stride == 1:
                x = halo(x, kh - 1 - p, p)
                row_pad = kh - 1
        y = quant.conv_transpose_maybe_quantized(x, self, row_pad is not None)
        if y is not None:
            return y
        pad = p if row_pad is None else (row_pad, p)
        return conv_transpose2d(quant.unwrap(x), self.weight, self.bias, self.stride, pad)


class Linear(nn.Module):
    int8_prequantizable = True

    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x, qw=None):
        """qw: a prequantization to use instead of the module's own."""
        return linear_q(x, self.weight, self.bias, qw or quant.prequant_of(self))


class Norm(nn.Module):
    """Holds a (C,) weight and bias for layer_norm or group_norm."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))


def mlp2(c0, c1, c2, k0, k1, act=nn.GELU, bias2=True):
    """conv -> act -> conv, as the reference's nn.Sequential (keys 0 and 2)."""
    return nn.Sequential(Conv(c0, c1, k0), act(), Conv(c1, c2, k1, bias=bias2))
