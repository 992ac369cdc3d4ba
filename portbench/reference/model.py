"""The benchmark's plain reference of the S2M2 forward, in float32.

A frozen copy of the model's mathematics (the published S2M2,
arXiv:2507.13229; reference code src/s2m2/core/model/) written with plain
torch operations only: attention is softmax(q k^T / sqrt(d)) v by two
matrix products, the optimal-transport matcher is the log-space Sinkhorn
with a dustbin row and column, the upsamplers are unfold + softmax sums.
It imports nothing of the program under test, so a later change to the
program cannot move it. State-dict names are the reference's, so the same
weights load here and into the program.

Activations are NCHW; the two views travel batch-concatenated (left
first) through the shared trunk. Images enter as (B, H, W, 3) in [0, 255]
with H, W multiples of 32; outputs are (disp, occ, conf), each
(B, H, W, 1). Run it under float32 with TF32 off (`configure_numerics`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def configure_numerics():
    """Plain float32: no TF32 in matrix products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- primitives

def layer_norm(x, weight=None, bias=None, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight + bias
    return y


def group_norm(x, weight, bias, groups=8, eps=1e-5):
    b, c, h, w = x.shape
    xg = x.reshape(b, groups, c // groups, h, w)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = (xg - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    return y * weight.view(1, c, 1, 1) + bias.view(1, c, 1, 1)


def upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def unfold9(x):
    """3x3 neighbourhood, replicate-padded, tap-major channels."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1), mode="replicate")
    return torch.cat([xp[..., i:i + h, j:j + w] for i in range(3) for j in range(3)], dim=1)


def logit(x, eps):
    x = x.clamp(eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


def lse(x, dim):
    m = x.amax(dim=dim, keepdim=True)
    return m + torch.log(torch.exp(x - m).sum(dim=dim, keepdim=True).clamp(min=1e-30))


def attention(q, k, v):
    """softmax(q k^T / sqrt(d)) v on (B, N, d) rows."""
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.matmul(torch.softmax(s, dim=-1), v)


def sinkhorn_ot(f0, f1, ot_iter, positivity):
    """Per row: correlation, the upper triangle masked under positivity, a
    zero dustbin row and column, `ot_iter` log-space Sinkhorn iterations
    with marginals 1/2W (pixels) and 1/2 (dustbin); returns the W x W
    transport probabilities scaled by 2W, and the raw correlation."""
    b, h, w, c = f0.shape
    cv = torch.matmul(f0.reshape(b * h, w, c), f1.reshape(b * h, w, c).transpose(1, 2))
    i = torch.arange(w, device=f0.device).view(1, w, 1)
    j = torch.arange(w, device=f0.device).view(1, 1, w)
    upper = j > i
    s = cv.masked_fill(upper, -1e4) if positivity else cv
    s = F.pad(s, (0, 1, 0, 1))
    idx = torch.arange(w + 1, device=f0.device).view(1, 1, w + 1)
    log_nu = torch.where(idx == w, math.log(0.5), -math.log(2.0 * w)).float()
    log_mu = log_nu.transpose(1, 2)
    v = log_nu - lse(s, 1)
    u = log_mu - lse(s + v, 2)
    for _ in range(ot_iter - 1):
        v = log_nu - lse(s + u, 1)
        u = log_mu - lse(s + v, 2)
    prob = torch.exp((s + u + v)[:, :w, :w] + math.log(2.0 * w))
    if positivity:
        prob = prob.masked_fill(upper, 0.0)
    return prob.reshape(b, h, w, w), cv.reshape(b, h, w, w)


def pe_axis_table(n, pe_dim):
    """The sinc relative positional table of one axis, (n, n, pe_dim/2)
    (reference: core/model/utils.py:32-60, with its 3.1415)."""
    half = pe_dim // 2
    pos = np.tanh(np.linspace(-3.0, 3.0, 2 * n + 1, dtype=np.float32))
    dim_t = np.linspace(-1.0, 1.0, half, dtype=np.float32)
    x = (dim_t[None, :] - pos[:, None]) / (5.0 / pe_dim)
    px = 3.1415 * x
    safe = np.where(np.abs(x) < 1e-6, 1.0, px)
    tab = np.where(np.abs(x) < 1e-6, 1.0, np.sin(px) / safe).astype(np.float32)
    tab = tab / np.clip(np.linalg.norm(tab, axis=-1, keepdims=True), 1e-12, None)
    q = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    return tab[q - k + n - 1]


def pe_contract(attn, h, w, pe_dim):
    """einsum('...ij,ijc->...ic', attn, pe) with the separable relative PE
    pe[i, j] = 0.5 * (TX[x_i - x_j], TY[y_i - y_j])."""
    ty = torch.tensor(pe_axis_table(h, pe_dim), device=attn.device)
    tx = torch.tensor(pe_axis_table(w, pe_dim), device=attn.device)
    lead = attn.shape[:-2]
    a = attn.reshape(*lead, h, w, h, w)
    ps_x = torch.einsum("...hqk,qkc->...hqc", a.sum(dim=-2), tx).reshape(*lead, h * w, -1)
    ps_y = torch.einsum("...qwk,qkc->...qwc", a.sum(dim=-1), ty).reshape(*lead, h * w, -1)
    return 0.5 * torch.cat([ps_x, ps_y], dim=-1)


# ------------------------------------------------------------ weight holders

def round_tf32(t):
    """float32 t rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero), as the tensor cores read a TF32 operand."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _Gemm(nn.Module):
    """A conv or linear. With `tf32` set (never in the reference itself, only
    in the lower-precision control) its input and weight are rounded to
    TF32 first, the product accumulating in float32."""

    tf32 = False

    def gemm(self, fn, x, *args):
        if self.tf32:
            return fn(round_tf32(x), round_tf32(self.weight), self.bias, *args)
        return fn(x, self.weight, self.bias, *args)


class Conv(_Gemm):
    """Conv2d, weight (O, I, kh, kw), padding k // 2 per side."""

    def __init__(self, cin, cout, k, stride=1, bias=True):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride = stride

    def fan_in(self):
        return self.weight[0].numel()

    def forward(self, x):
        kh, kw = self.weight.shape[2:]
        return self.gemm(F.conv2d, x, self.stride, (kh // 2, kw // 2))


class ConvT(_Gemm):
    """ConvTranspose2d, weight (I, O, kh, kw)."""

    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride = stride
        self.padding = padding

    def fan_in(self):
        return self.weight.shape[0] * self.weight.shape[2] * self.weight.shape[3]

    def forward(self, x):
        return self.gemm(F.conv_transpose2d, x, self.stride, self.padding)


class Linear(_Gemm):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def fan_in(self):
        return self.weight.shape[1]

    def forward(self, x):
        return self.gemm(F.linear, x)


class Norm(nn.Module):
    """Weight and bias of a norm; they start at 1 and 0."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))


class Fn(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def mlp2(c0, c1, c2, k0, k1, act=nn.GELU, bias2=True):
    return nn.Sequential(Conv(c0, c1, k0), act(), Conv(c1, c2, k1, bias=bias2))


def down(cin, cout):
    return nn.Sequential(Fn(lambda x: F.avg_pool2d(x, 2)), Conv(cin, cout, 1))


def up(cin, cout):
    return nn.Sequential(Fn(upsample2x), Conv(cin, cout, 1))


# --------------------------------------------------------------- attention

def fold_heads(x, nh):
    b, n, e = x.shape
    return x.reshape(b, n, nh, e // nh).transpose(1, 2).reshape(b * nh, n, e // nh)


def unfold_heads(x, nh):
    bh, n, d = x.shape
    return x.reshape(bh // nh, nh, n, d).transpose(1, 2).reshape(bh // nh, n, nh * d)


class SelfAttn(nn.Module):
    def __init__(self, d, heads, e=1, use_pe=False, pe_dim=32):
        super().__init__()
        self.heads = heads
        self.pe_dim = pe_dim
        self.q = Linear(d, e * d, bias=False)
        self.k = Linear(d, e * d, bias=False)
        self.v = Linear(d, e * d)
        self.proj = Linear(e * d, d, bias=False)
        if use_pe:
            self.pe_proj = Linear(pe_dim, e * d // heads)

    def forward(self, x, hw=None):
        nh = self.heads
        q, k, v = (fold_heads(f(x), nh) for f in (self.q, self.k, self.v))
        if hw is None:
            return self.proj(unfold_heads(attention(q, k, v), nh))
        s = torch.matmul(q * q.shape[-1] ** -0.5, k.transpose(-1, -2))
        p = torch.softmax(s, dim=-1)
        out = torch.matmul(p, v) + self.pe_proj(pe_contract(p, *hw, self.pe_dim))
        return self.proj(unfold_heads(out, nh))


class CrossAttn(nn.Module):
    """Weight-shared bidirectional cross attention on the packed (left |
    right) batch: the left view attends to the right and back."""

    def __init__(self, d, heads, e=1):
        super().__init__()
        self.heads = heads
        self.q = Linear(d, e * d, bias=False)
        self.k = Linear(d, e * d, bias=False)
        self.v = Linear(d, e * d)
        self.proj = Linear(e * d, d, bias=False)

    def forward(self, xy):
        nh = self.heads
        q, k, v = (fold_heads(f(xy), nh) for f in (self.q, self.k, self.v))
        b = q.shape[0] // 2
        out = torch.cat([attention(q[:b], k[b:], v[b:]), attention(q[b:], k[:b], v[:b])])
        return self.proj(unfold_heads(out, nh))


class FFN(nn.Module):
    def __init__(self, d, e=1):
        super().__init__()
        self.ffn = nn.Sequential(Linear(d, e * d), nn.GELU(), Linear(e * d, d))

    def forward(self, z):
        return self.ffn(layer_norm(z)) + z


class SelfAttnBlock(nn.Module):
    def __init__(self, d, heads, e=1, use_pe=False, pe_dim=32):
        super().__init__()
        self.attn = SelfAttn(d, heads, e, use_pe, pe_dim)

    def forward(self, z, hw=None):
        return self.attn(layer_norm(z), hw) + z


class CrossAttnBlock(nn.Module):
    def __init__(self, d, heads, e=1):
        super().__init__()
        self.attn = CrossAttn(d, heads, e)

    def forward(self, z):
        return self.attn(layer_norm(z)) + z


class BasicAttnBlock(nn.Module):
    """Scanline block: each image row is a sequence; cross, FFN, self, FFN."""

    def __init__(self, d, heads, e=1):
        super().__init__()
        self.cross_attn = CrossAttnBlock(d, heads, e)
        self.self_attn = SelfAttnBlock(d, heads, e)
        self.ffn_c = FFN(d, e)
        self.ffn = FFN(d, e)

    def forward(self, z):
        b, c, h, w = z.shape
        t = z.permute(0, 2, 3, 1).reshape(b * h, w, c)
        t = self.ffn(self.self_attn(self.ffn_c(self.cross_attn(t))))
        return t.reshape(b, h, w, c).permute(0, 3, 1, 2)


class GlobalAttnBlock(nn.Module):
    """[cross + FFN] + self + FFN over all h*w tokens of a map."""

    def __init__(self, d, heads, e=1, use_cross_attn=False, use_pe=False, pe_dim=32):
        super().__init__()
        self.use_pe = use_pe
        self.self_attn = SelfAttnBlock(d, heads, e, use_pe, pe_dim)
        self.ffn = FFN(d, e)
        if use_cross_attn:
            self.cross_attn = CrossAttnBlock(d, heads, e)
            self.ffn_c = FFN(d, e)

    def forward(self, z):
        b, c, h, w = z.shape
        t = z.permute(0, 2, 3, 1).reshape(b, h * w, c)
        if hasattr(self, "cross_attn"):
            t = self.ffn_c(self.cross_attn(t))
        t = self.ffn(self.self_attn(t, (h, w) if self.use_pe else None))
        return t.reshape(b, h, w, c).permute(0, 3, 1, 2)


class ConvBlock2D(nn.Module):
    def __init__(self, d, e=1):
        super().__init__()
        self.convs = mlp2(d, e * d, d, 3, 3)
        self.convs_1x = mlp2(d, e * d, d, 1, 1, act=nn.ReLU)

    def forward(self, z):
        return self.convs(z) + self.convs_1x(z)


class FeatureFusion(nn.Module):
    """fusion(z0 | z1) + w z0 + (1 - w) z1, w a gate clamped to [.01, .99]."""

    def __init__(self, d, k):
        super().__init__()
        self.feature_fusion = mlp2(2 * d, 2 * d, d, k, 1)
        self.feature_gate = mlp2(2 * d, d, d, k, 1)

    def forward(self, z0, z1):
        z = torch.cat([z0, z1], dim=1)
        w = torch.sigmoid(self.feature_gate(z)).clamp(0.01, 0.99)
        return self.feature_fusion(z) + w * z0 + (1.0 - w) * z1


# ------------------------------------------------------------------ trunks

class UNet(nn.Module):
    def __init__(self, dims, e, use_pe, n_attn, pe_dim=32):
        super().__init__()
        d0, d1, d2 = dims
        self.down_conv0, self.down_conv1, self.down_conv2 = down(d0, d1), down(d1, d2), down(d2, d2)
        self.up_conv0, self.up_conv1, self.up_conv2 = up(d1, d0), up(d2, d1), up(d2, d2)
        self.concat_conv0 = FeatureFusion(d0, 1)
        self.concat_conv1 = FeatureFusion(d1, 1)
        self.concat_conv2 = FeatureFusion(d2, 1)
        self.enc0, self.enc1, self.enc2 = ConvBlock2D(d0, e), ConvBlock2D(d1, e), ConvBlock2D(d2, e)
        self.dec0, self.dec1, self.dec2 = ConvBlock2D(d0, e), ConvBlock2D(d1, e), ConvBlock2D(d2, e)
        self.enc3s = nn.ModuleList(GlobalAttnBlock(d2, 8, e, use_pe=use_pe, pe_dim=pe_dim)
                                   for _ in range(n_attn))
        self.dec3s = nn.ModuleList(GlobalAttnBlock(d2, 8, e) for _ in range(n_attn))

    def forward(self, z):
        z0 = self.enc0(z)
        z1 = self.enc1(self.down_conv0(z0))
        z2 = self.enc2(self.down_conv1(z1))
        z3 = self.down_conv2(z2)
        for blk in (*self.enc3s, *self.dec3s):
            z3 = blk(z3)
        z2 = self.dec2(self.concat_conv2(z2, self.up_conv2(z3)))
        z1 = self.dec1(self.concat_conv1(z1, self.up_conv1(z2)))
        z0 = self.dec0(self.concat_conv0(z0, self.up_conv0(z1)))
        return z0, z1, z2, z3


class MRT(nn.Module):
    """Multi-resolution transformer: scanline blocks at three scales, global
    cross-view blocks at the 1/32 bottleneck."""

    def __init__(self, dims, heads, e=1):
        super().__init__()
        d0, d1, d2 = dims
        self.down_conv0, self.down_conv1, self.down_conv2 = down(d0, d1), down(d1, d2), down(d2, d2)
        self.up_conv0, self.up_conv1, self.up_conv2 = up(d1, d0), up(d2, d1), up(d2, d2)
        self.down_concat1 = FeatureFusion(d1, 1)
        self.down_concat2 = FeatureFusion(d2, 1)
        self.down_concat3 = FeatureFusion(d2, 1)
        self.up_concat0 = FeatureFusion(d0, 1)
        self.up_concat1 = FeatureFusion(d1, 1)
        self.up_concat2 = FeatureFusion(d2, 1)
        self.enc_attn0 = BasicAttnBlock(d0, heads, e)
        self.enc_attn1 = BasicAttnBlock(d1, 2 * heads, e)
        self.enc_attn2 = BasicAttnBlock(d2, 4 * heads, e)
        self.enc_attn3s = nn.ModuleList(GlobalAttnBlock(d2, 8 * heads, e, use_cross_attn=True)
                                        for _ in range(2))
        self.dec_attn0 = BasicAttnBlock(d0, heads, e)
        self.dec_attn1 = BasicAttnBlock(d1, 2 * heads, e)
        self.dec_attn2 = BasicAttnBlock(d2, 4 * heads, e)
        self.dec_attn3s = nn.ModuleList(GlobalAttnBlock(d2, 8 * heads, e, use_cross_attn=True)
                                        for _ in range(2))

    def forward(self, z0, z1, z2, z3):
        z0 = self.enc_attn0(z0)
        z1 = self.enc_attn1(self.down_concat1(z1, self.down_conv0(z0)))
        z2 = self.enc_attn2(self.down_concat2(z2, self.down_conv1(z1)))
        z3 = self.down_concat3(z3, self.down_conv2(z2))
        for blk in (*self.enc_attn3s, *self.dec_attn3s):
            z3 = blk(z3)
        z2 = self.dec_attn2(self.up_concat2(z2, self.up_conv2(z3)))
        z1 = self.dec_attn1(self.up_concat1(z1, self.up_conv1(z2)))
        z0 = self.dec_attn0(self.up_concat0(z0, self.up_conv0(z1)))
        return z0, z1, z2, z3


class StackedMRT(nn.Module):
    def __init__(self, dims, n, heads, e=1):
        super().__init__()
        self.uformer_list = nn.ModuleList(MRT(dims, heads, e) for _ in range(n))

    def forward(self, z0, z1, z2, z3):
        for m in self.uformer_list:
            z0, z1, z2, z3 = m(z0, z1, z2, z3)
        return z0


class CNNEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv0 = mlp2(3, 16, 16, 1, 1)
        self.conv1_down = nn.Sequential(Conv(16, 64, 5, stride=2), nn.GELU(), Conv(64, c, 3))
        self.norm1 = Norm(c)
        self.conv2 = mlp2(c, c, c, 3, 3)
        self.conv2_down = nn.Sequential(Conv(c, c, 3, stride=2))

    def forward(self, x):
        x2 = group_norm(self.conv1_down(self.conv0(x)), self.norm1.weight, self.norm1.bias)
        x2 = self.conv2(x2) + x2
        return self.conv2_down(x2), x2


# ------------------------------------------------------ matcher, refiners

class DispInit(nn.Module):
    """Optimal-transport matching and a windowed soft-argmax around each
    row's best match."""

    def __init__(self, c):
        super().__init__()
        self.layer_norm = Norm(c)

    def forward(self, feature, ot_iter, positivity, window=2):
        w = feature.shape[3]
        feat = layer_norm(feature.permute(0, 2, 3, 1), self.layer_norm.weight,
                          self.layer_norm.bias)
        f0, f1 = feat.chunk(2, dim=0)
        prob, cv = sinkhorn_ot(f0, f1, ot_iter, positivity)
        j = torch.arange(w, device=feature.device)
        in_window = ((j - prob.argmax(dim=3, keepdim=True)).abs() <= window).float()
        conf = (prob * in_window).sum(dim=3, keepdim=True)
        corr = (prob * in_window * j.float()).sum(dim=3, keepdim=True)
        corr = (corr + 1e-4) / (conf + 1e-4)
        disp = j.float().view(1, 1, w, 1) - corr
        occ = prob.sum(dim=3, keepdim=True)
        return tuple(t.permute(0, 3, 1, 2) for t in (disp, conf, occ)) + (cv,)


def interp1d(vol, pos):
    """Linear interpolation along the last axis, zero outside per tap
    (grid_sample with zero padding at integer rows)."""
    w2 = vol.shape[-1]
    x0 = torch.floor(pos)
    a = pos - x0
    i0 = x0.long()

    def tap(i):
        inside = (i >= 0) & (i <= w2 - 1)
        return torch.gather(vol, -1, i.clamp(0, w2 - 1)) * inside

    return tap(i0) * (1.0 - a) + tap(i0 + 1) * a


def lookup(cv, disp, radius):
    """Correlation at disp +- radius taps, at full and half width."""
    b, h, w, w2 = cv.shape
    cv2 = cv.reshape(b, h, w, w2 // 2, 2).mean(dim=-1)
    dx = torch.linspace(-radius, radius, 2 * radius + 1, device=cv.device).view(1, 1, 1, -1)
    x = torch.arange(w, dtype=torch.float32, device=cv.device).view(1, 1, w, 1)
    d = disp.permute(0, 2, 3, 1)
    c1 = interp1d(cv, x - d + dx).permute(0, 3, 1, 2)
    c2 = interp1d(cv2, x / 2.0 - d / 2.0 + dx).permute(0, 3, 1, 2)
    return c1, c2


class ConvGRU(nn.Module):
    def __init__(self, c):
        super().__init__()
        for name, k in (("1", (3, 1)), ("2", (1, 3))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{name}", Conv(2 * c, c, k))

    def forward(self, h, x):
        for name in "12":
            cz, cr, cq = (getattr(self, f"conv{g}{name}") for g in "zrq")
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(cz(hx))
            r = torch.sigmoid(cr(hx))
            q = torch.tanh(cq(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class GlobalRefiner(nn.Module):
    """Inpaints the disparity where the matcher's confidence is low."""

    def __init__(self, c):
        super().__init__()
        self.init_feat = mlp2(2 + c, c, c, 3, 1)
        self.refine_unet = UNet([c, c, c], 1, False, 1)
        self.out_feat = nn.Sequential(Conv(c, 1, 3))

    def forward(self, ctx, disp, conf):
        mask = (conf > 0.2).float()
        feat = torch.cat([disp / 1e2 * mask, logit(mask * conf, 1e-1), ctx], dim=1)
        update = self.out_feat(self.refine_unet(self.init_feat(feat))[0]) * 1e2
        return mask * disp + (1 - mask) * update


class LocalRefiner(nn.Module):
    """One recurrent update of disparity, confidence and occlusion."""

    def __init__(self, c, dims, e, radius):
        super().__init__()
        taps = 2 * radius + 1
        self.radius = radius
        self.disp_feat = mlp2(1, 96, 96, 3, 3)
        self.corr_feat1 = mlp2(taps, 96, 64, 1, 1)
        self.corr_feat2 = mlp2(taps, 96, 64, 1, 1)
        self.conf_occ_feat = mlp2(2, 64, 32, 3, 1)
        self.disp_corr_ctx_cat = mlp2(256 + c, 2 * c, c, 1, 3)
        self.refine_unet = UNet(dims, e, False, 1)
        self.disp_update = mlp2(c, c, 1, 3, 3, bias2=False)
        self.conf_occ_update = mlp2(c, c, 2, 3, 3, bias2=False)
        self.gru = ConvGRU(c)

    def forward(self, hidden, ctx, disp, conf, occ, cv):
        conf_logit, occ_logit = logit(conf, 1e-2), logit(occ, 1e-2)
        c1, c2 = lookup(cv, disp, self.radius)
        cat = torch.cat([self.disp_feat(disp / 1e2), self.corr_feat1(c1 / 16),
                         self.corr_feat2(c2 / 16), ctx,
                         self.conf_occ_feat(torch.cat([conf_logit, occ_logit], dim=1))], dim=1)
        hidden = self.gru(hidden, self.refine_unet(self.disp_corr_ctx_cat(cat))[0])
        co = self.conf_occ_update(hidden)
        return (hidden, disp + self.disp_update(hidden), torch.sigmoid(co[:, 0:1] + conf_logit),
                torch.sigmoid(co[:, 1:2] + occ_logit))


class UpsampleMask4x(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv_x = ConvT(c, 64, 2, stride=2)
        self.conv_y = Conv(c, 64, 3)
        self.conv_concat = nn.Sequential(Conv(128, 128, 3), nn.ReLU(), ConvT(128, 9, 2, stride=2))

    def forward(self, x, y):
        return self.conv_concat(torch.cat([self.conv_x(x), self.conv_y(y)], dim=1))


class UpsampleMask1x(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv_disp = nn.Sequential(ConvT(1, 16, 3, padding=1), nn.ReLU())
        self.conv_rgb = nn.Sequential(ConvT(3, 16, 3, padding=1), nn.ReLU())
        self.conv_ctx = ConvT(c, 16, 2, stride=2)
        self.conv_concat = nn.Sequential(Conv(48, 48, 3), nn.ReLU(), ConvT(48, 9, 1))

    def forward(self, disp, rgb, ctx):
        return self.conv_concat(torch.cat([self.conv_disp(disp), self.conv_rgb(rgb),
                                           self.conv_ctx(ctx)], dim=1))


def convex_upsample4x(x, mask):
    """Each of 4x4 output pixels: a softmax(mask)-weighted sum of the 3x3
    neighbourhood of its coarse pixel."""
    b, c, h, w = x.shape
    xu = unfold9(x).reshape(b, 9, c, h, w)
    xu = xu.repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1)
    return (xu * torch.softmax(mask, dim=1).unsqueeze(2)).sum(dim=1)


def edge_filter(x, weights, output_upsample):
    """The edge-guided 3x3 filter at full resolution (x2 under
    output_upsample, with the weights upsampled bilinearly)."""
    b, c, h, w = x.shape
    xu = unfold9(x).reshape(b, 9, c, h, w)
    if output_upsample:
        xu = xu.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        weights = upsample2x(weights)
    return (xu * torch.softmax(weights, dim=1).unsqueeze(2)).sum(dim=1)


class S2M2(nn.Module):
    """The whole model. `cfg` is a mapping with feature_channels,
    num_transformer, dim_expansion, num_heads, use_positivity,
    output_upsample, refine_iter, ot_iter, radius and pe_dim."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = dict(cfg)
        c, e = cfg["feature_channels"], cfg["dim_expansion"]
        dims = [c, c, 2 * c]
        self.cnn_backbone = CNNEncoder(c)
        self.feat_pyramid = UNet(dims, e, True, cfg["num_transformer"] * 2, cfg["pe_dim"])
        self.transformer = StackedMRT(dims, cfg["num_transformer"], cfg["num_heads"], e)
        self.disp_init = DispInit(c)
        self.upsample_mask_1x = UpsampleMask1x(c)
        self.upsample_mask_4x_refine = UpsampleMask4x(c)
        self.global_refiner = GlobalRefiner(c)
        self.feat_fusion_layer = FeatureFusion(c, 3)
        self.refiner = LocalRefiner(c, dims, e, cfg["radius"])
        self.ctx_feat = mlp2(c, c, c, 1, 1)

    def forward(self, img0, img1, match_conf=False):
        """(disp, occ, conf); with `match_conf`, also the matcher's
        confidence of the left view, (B, 1, H/4, W/4): the transport mass
        within two columns of each pixel's best match."""
        cfg = self.cfg
        pos = cfg["use_positivity"]
        x0 = (img0.permute(0, 3, 1, 2) / 255.0 - 0.5) * 2.0
        x1 = (img1.permute(0, 3, 1, 2) / 255.0 - 0.5) * 2.0
        f4, f2 = self.cnn_backbone(torch.cat([x0, x1]))
        f0_2x = f2.chunk(2)[0]
        p4, p8, p16, p32 = self.feat_pyramid(f4)
        t4 = self.transformer(p4, p8, p16, p32)
        disp, conf, occ, cv = self.disp_init(t4, cfg["ot_iter"], pos)
        matched = conf
        t0_4x = t4.chunk(2)[0]
        disp = self.global_refiner(t0_4x, disp, conf)
        if pos:
            disp = disp.clamp(min=0)
        fused = self.feat_fusion_layer(t0_4x, p4.chunk(2)[0])
        ctx = self.ctx_feat(fused)
        hidden = torch.tanh(ctx)
        x = torch.arange(fused.shape[3], dtype=torch.float32, device=disp.device)
        for _ in range(cfg["refine_iter"]):
            hidden, disp, conf, occ = self.refiner(hidden, ctx, disp, conf, occ, cv)
            if pos:
                disp = disp.clamp(min=0)
            occ = occ * ((x - disp) >= 0)
        mask = self.upsample_mask_4x_refine(hidden, f0_2x)
        full = convex_upsample4x(torch.cat([disp * 4, occ, conf], dim=1), mask)
        filt = self.upsample_mask_1x(full[:, 0:1], x0, f0_2x)
        up = cfg["output_upsample"]
        out = edge_filter(full, filt, up)
        if up:
            out = out * torch.tensor([2.0, 1.0, 1.0], device=out.device).view(1, 3, 1, 1)
        maps = tuple(out[:, i:i + 1].permute(0, 2, 3, 1) for i in range(3))
        return maps + (matched,) if match_conf else maps
