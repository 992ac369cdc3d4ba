"""RAFT-Stereo (Lipson, Teed, Deng, 3DV 2021, arXiv:2109.07547), the
inference forward of the published code (github.com/princeton-vl/RAFT-Stereo,
core/raft_stereo.py, extractor.py, update.py, corr.py) in float32.

Parameter and buffer names are the published module tree's (the
DataParallel `module.` prefix stripped), so a published state dict loads by
name. Every conv is a `layers.Conv`: on the card its float32 spatial
stride-1 convs with 16+ inputs and 32+ outputs run on kernel G (the GRUs,
the heads, the motion encoder, the encoders' residual blocks), the 7x7,
strided and 1x1 convs and the 2-output flow conv on cuDNN.

Images enter as (B, H, W, 3) in [0, 255], H and W multiples of
2**n_downsample (the engine pads to 32); the output is the disparity,
(B, H, W, 1), the demo's sign: minus the flow's x component, positive,
in S2M2's triple (disp, None, None): no occlusion, no confidence.

Two things of the published loop whose results are never read are left
out, so no output bit changes: the mask head runs after the last
iteration only (the published loop runs it in every one), and the
pyramid has `corr_levels` levels (the published CorrBlock1D builds one
more, which no lookup reads). The flow's y component is 0 throughout (each
update's is zeroed), so the loop carries x alone and the convex upsampling
upsamples x alone.

The forward's stages are spans of runtime/trace.py: forward.encode,
forward.correlation, forward.update (the loop) and forward.upsample; the
counter `raft.iters` adds the iterations run times the pairs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import RaftStereoConfig
from ..runtime import trace
from .cost_volume import lookup_pyramid, make_pyramid, taps
from .layers import Conv


def _norm(kind, c):
    """The published encoders' norms: eval-mode batch norm with its running
    statistics, or instance norm with no affine (eps 1e-5 both)."""
    return nn.BatchNorm2d(c) if kind == "batch" else nn.InstanceNorm2d(c)


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout, norm, stride=1):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride=stride)
        self.conv2 = Conv(cout, cout, 3)
        self.norm1 = _norm(norm, cout)
        self.norm2 = _norm(norm, cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.norm3 = _norm(norm, cout)
            self.downsample = nn.Sequential(Conv(cin, cout, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class _Trunk(nn.Module):
    """conv1 7x7 3->64 with its norm, then layer1-3 (64, 96, 128), two
    residual blocks each; strides 2 where n_downsample asks, from the
    deepest layer up."""

    def _trunk(self, norm, downsample):
        self.norm1 = _norm(norm, 64)
        self.conv1 = Conv(3, 64, 7, stride=1 + (downsample > 2))
        self.layer1 = self._layer(64, 64, norm, 1)
        self.layer2 = self._layer(64, 96, norm, 1 + (downsample > 1))
        self.layer3 = self._layer(96, 128, norm, 1 + (downsample > 0))

    @staticmethod
    def _layer(cin, cout, norm, stride):
        return nn.Sequential(ResidualBlock(cin, cout, norm, stride),
                             ResidualBlock(cout, cout, norm, 1))

    def stem(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.layer3(self.layer2(self.layer1(x)))


class BasicEncoder(_Trunk):
    """The feature encoder: the trunk, then conv2 1x1 128->output_dim."""

    def __init__(self, output_dim, norm, downsample):
        super().__init__()
        self._trunk(norm, downsample)
        self.conv2 = Conv(128, output_dim, 1)

    def forward(self, x):
        return self.conv2(self.stem(x))


class MultiBasicEncoder(_Trunk):
    """The context encoder: the trunk, layer4 and layer5 (128, stride 2),
    and for each output j (hidden, context) a head at 1/f, 1/2f, 1/4f."""

    def __init__(self, output_dims, norm, downsample):
        super().__init__()
        self._trunk(norm, downsample)
        self.layer4 = self._layer(128, 128, norm, 2)
        self.layer5 = self._layer(128, 128, norm, 2)
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm), Conv(128, d[2], 3)) for d in output_dims)
        self.outputs16 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm), Conv(128, d[1], 3)) for d in output_dims)
        self.outputs32 = nn.ModuleList(Conv(128, d[0], 3) for d in output_dims)

    def forward(self, x):
        """[(hidden, context) at 1/f, at 1/2f, at 1/4f]."""
        x = self.stem(x)
        y = self.layer4(x)
        z = self.layer5(y)
        return [tuple(f(t) for f in heads) for t, heads in
                ((x, self.outputs08), (y, self.outputs16), (z, self.outputs32))]


class ConvGRU(nn.Module):
    """h' = (1 - z) h + z q, z and r sigmoids and q a tanh of 3x3 convs of
    [h, x] plus their context biases cz, cr, cq (q's of [r h, x])."""

    def __init__(self, hidden, cin):
        super().__init__()
        self.convz = Conv(hidden + cin, hidden, 3)
        self.convr = Conv(hidden + cin, hidden, 3)
        self.convq = Conv(hidden + cin, hidden, 3)

    def forward(self, h, cz, cr, cq, *xs):
        x = torch.cat(xs, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    """128 channels from the flow and its correlation taps: 126 of the two
    branches' 3x3 conv, then the flow itself."""

    def __init__(self, cor_planes):
        super().__init__()
        self.convc1 = Conv(cor_planes, 64, 1)
        self.convc2 = Conv(64, 64, 3)
        self.convf1 = Conv(2, 64, 7)
        self.convf2 = Conv(64, 64, 3)
        self.conv = Conv(128, 126, 3)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([cor, flo], dim=1))), flow], dim=1)


class FlowHead(nn.Module):
    def __init__(self, cin, hidden=256, cout=2):
        super().__init__()
        self.conv1 = Conv(cin, hidden, 3)
        self.conv2 = Conv(hidden, cout, 3)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


def pool2x(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1)


def interp(x, dest):
    """x resized bilinearly to dest's (H, W), align_corners=True."""
    return F.interpolate(x, dest.shape[2:], mode="bilinear", align_corners=True)


class BasicMultiUpdateBlock(nn.Module):
    """One iteration's three GRUs, coarsest first, each seeing the coarser
    state just updated and the finer one from before; the flow head and
    the mask head (`mask`, run by the caller after the last iteration)."""

    def __init__(self, cfg: RaftStereoConfig):
        super().__init__()
        d = cfg.hidden_dims
        self.encoder = BasicMotionEncoder(cfg.corr_levels * (2 * cfg.corr_radius + 1))
        self.gru08 = ConvGRU(d[2], 128 + d[1])
        self.gru16 = ConvGRU(d[1], d[0] + d[2])
        self.gru32 = ConvGRU(d[0], d[1])
        self.flow_head = FlowHead(d[2])
        f = 2 ** cfg.n_downsample
        self.mask = nn.Sequential(Conv(d[2], 256, 3), nn.ReLU(), Conv(256, f * f * 9, 1))

    def forward(self, net, inp, corr, flow):
        """The new (net08, net16, net32) and the flow's x update."""
        n08, n16, n32 = net
        n32 = self.gru32(n32, *inp[2], pool2x(n16))
        n16 = self.gru16(n16, *inp[1], pool2x(n08), interp(n32, n16))
        n08 = self.gru08(n08, *inp[0], self.encoder(flow, corr), interp(n16, n08))
        return (n08, n16, n32), self.flow_head(n08)[:, :1]


def correlation(fmap1, fmap2):
    """(B, H, W1, W2): each row's dot products of the (B, C, H, W) feature
    maps over the channels / sqrt(C)."""
    c = fmap1.shape[1]
    corr = torch.matmul(fmap1.permute(0, 2, 3, 1), fmap2.permute(0, 2, 1, 3))
    return corr / math.sqrt(c)


def convex_upsample(flow, mask, factor):
    """(B, 1, H, W) flow at 1/factor -> (B, 1, fH, fW): each fine pixel the
    softmax(mask)-weighted sum of its coarse pixel's 3x3 neighbourhood of
    factor x flow, zero-padded at the borders (F.unfold's padding)."""
    b, _, h, w = flow.shape
    mask = torch.softmax(mask.view(b, 1, 9, factor, factor, h, w), dim=2)
    up = F.unfold(factor * flow, [3, 3], padding=1).view(b, 1, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(b, 1, factor * h, factor * w)


class RAFTStereo(nn.Module):
    """The whole model; `state_dict()` keys equal the published checkpoints'
    with the `module.` prefix stripped."""

    def __init__(self, cfg: RaftStereoConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dims
        self.cnet = MultiBasicEncoder([d, d], "batch", cfg.n_downsample)
        self.update_block = BasicMultiUpdateBlock(cfg)
        self.context_zqr_convs = nn.ModuleList(Conv(d[i], 3 * d[i], 3) for i in range(3))
        self.fnet = BasicEncoder(256, "instance", cfg.n_downsample)

    def forward(self, img0, img1, iters=None):
        """img0/img1: (B, H, W, 3) in [0, 255]. Returns S2M2's (disp, occ,
        conf) with the disparity (B, H, W, 1) after `iters` iterations (the
        configuration's by default) and None for the maps it does not make."""
        cfg = self.cfg
        iters = cfg.iters if iters is None else iters
        with trace.span("forward.encode"):
            # NCHW from here on, as the published forward makes them: the
            # layout the convs and norms are written for
            a = (2 * (img0.permute(0, 3, 1, 2) / 255.0) - 1.0).contiguous()
            b = (2 * (img1.permute(0, 3, 1, 2) / 255.0) - 1.0).contiguous()
            levels = self.cnet(a)
            net = tuple(torch.tanh(h) for h, _ in levels)
            inp = [conv(F.relu(c)).chunk(3, dim=1)
                   for (_, c), conv in zip(levels, self.context_zqr_convs)]
            fmap1, fmap2 = self.fnet(torch.cat([a, b])).chunk(2)
        with trace.span("forward.correlation"):
            pyramid = make_pyramid(correlation(fmap1, fmap2), cfg.corr_levels)
        with trace.span("forward.update"):
            n, _, h, w = net[0].shape
            x0 = torch.arange(w, dtype=torch.float32, device=a.device).expand(n, 1, h, w)
            x1 = x0
            zero = torch.zeros_like(x0)
            dx = taps(cfg.corr_radius, a.device)
            for _ in range(iters):
                corr = torch.cat(lookup_pyramid(pyramid, x1[:, 0], dx), dim=1)
                flow = torch.cat([x1 - x0, zero], dim=1)
                net, delta = self.update_block(net, inp, corr, flow)
                x1 = x1 + delta
            trace.count("raft.iters", iters * n)
        with trace.span("forward.upsample"):
            mask = 0.25 * self.update_block.mask(net[0])
            up = convex_upsample(x1 - x0, mask, 2 ** cfg.n_downsample)
            return -up.permute(0, 2, 3, 1), None, None
