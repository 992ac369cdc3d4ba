"""Convex upsampling masks and the RAFT-style upsample ops
(reference: src/s2m2/core/model/submodules.py:96-145 and s2m2.py:101-133).

The plain forms of `s2m2_tpu/models/upsampling.py`; its `*_packed` forms
are exact TPU layout rewrites of the same functions. The mask heads' int8
sites are the packed forms' (`site_gate`, `quant.conv_transpose_maybe_quantized`).
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers
from .layers import Conv, ConvT


class UpsampleMask4x(nn.Module):
    """Hidden state (1/4 res) + CNN 1/2-res features -> 9-channel convex
    combination weights at full res (reference: submodules.py:96-115)."""

    def __init__(self, c):
        super().__init__()
        self.conv_x = ConvT(c, 64, 2, stride=2)
        self.conv_y = Conv(c, 64, 3)
        self.conv_concat = nn.Sequential(Conv(128, 128, 3), nn.ReLU(),
                                         ConvT(128, 9, 2, stride=2))
        # int8 sites of upsample_mask_4x_packed (s2m2_tpu upsampling.py:83-95):
        # the k2s2 ConvTs run there as 1x1 convs to 4x the channels
        self.conv_x.site_gate = (c, c, 4 * 64)
        self.conv_concat[2].site_gate = (128, 128, 4 * 9)

    def forward(self, feat_x, feat_y):
        return self.conv_concat(torch.cat([self.conv_x(feat_x), self.conv_y(feat_y)],
                                          dim=1))


class UpsampleMask1x(nn.Module):
    """Disparity + normalized RGB + 1/2-res features -> 9-channel
    edge-guided filter weights at full res (reference: submodules.py:118-145)."""

    def __init__(self, c):
        super().__init__()
        self.conv_disp = nn.Sequential(ConvT(1, 16, 3, padding=1), nn.ReLU())
        self.conv_rgb = nn.Sequential(ConvT(3, 16, 3, padding=1), nn.ReLU())
        self.conv_ctx = ConvT(c, 16, 2, stride=2)
        self.conv_concat = nn.Sequential(Conv(48, 48, 3), nn.ReLU(), ConvT(48, 9, 1))
        # int8 sites of upsample_mask_1x_packed (s2m2_tpu upsampling.py:110-127),
        # whose convs run on the phase-packed half-resolution grid:
        # pack_convT3x3 (3, 3, 4, 64) and (3, 3, 12, 64), pack_convT2x2
        # (1, 1, c, 64), pack_conv_s1 (3, 3, 192, 192), pack_pointwise (1, 1, 192, 36)
        self.conv_disp[0].site_gate = (9 * 4, 4, 4 * 16)
        self.conv_rgb[0].site_gate = (9 * 12, 12, 4 * 16)
        self.conv_ctx.site_gate = (c, c, 4 * 16)
        self.conv_concat[0].site_gate = (9 * 192, 192, 192)
        self.conv_concat[2].site_gate = (192, 192, 4 * 9)

    def forward(self, disp, rgb, ctx):
        z = torch.cat([self.conv_disp(disp), self.conv_rgb(rgb), self.conv_ctx(ctx)],
                      dim=1)
        return self.conv_concat(z)


def _softmax_w(w, dtype):
    """float32-statistics softmax over the 9 taps (dim 1)."""
    return torch.softmax(w.float(), dim=1).to(dtype)


def upsample4x(x, up_weights):
    """Convex 4x upsample of C maps with one shared mask: 3x3 unfold, nearest
    x4, softmax-weighted sum (reference: s2m2.py:101-114).
    x: (B, C, h, w); up_weights: (B, 9, 4h, 4w). Returns (B, C, 4h, 4w)."""
    b, c, h, w = x.shape
    xu = layers.unfold9(x).reshape(b, 9, c, h, w)
    xu = layers.upsample_nearest(xu, 4)
    wgt = _softmax_w(up_weights, x.dtype).unsqueeze(2)
    return (xu * wgt).sum(dim=1)


def upsample1x(disp, filter_weights, output_upsample=False):
    """Edge-guided 1x sharpening filter (reference: s2m2.py:116-133).
    disp: (B, 1, H, W); filter_weights: (B, 9, H, W)."""
    disp_unfold = layers.unfold9(disp)
    if output_upsample:
        disp_unfold = layers.upsample_nearest(disp_unfold, 2)
        filter_weights = layers.upsample2x_bilinear(filter_weights)
    wgt = _softmax_w(filter_weights, disp.dtype)
    return (disp_unfold * wgt).sum(dim=1, keepdim=True)


def upsample1x_multi(x, filter_weights):
    """The edge-guided filter on C maps with one shared softmax.
    x: (B, C, H, W); filter_weights: (B, 9, H, W). Returns (B, C, H, W)."""
    b, c, h, w = x.shape
    xu = layers.unfold9(x).reshape(b, 9, c, h, w)
    wgt = _softmax_w(filter_weights, x.dtype).unsqueeze(2)
    return (xu * wgt).sum(dim=1)
