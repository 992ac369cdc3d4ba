"""The benchmark's plain reference of the RAFT-Stereo forward, in float32.

RAFT-Stereo (Lipson, Teed, Deng, 3DV 2021, arXiv:2109.07547), the
published code's inference forward (github.com/princeton-vl/RAFT-Stereo:
core/raft_stereo.py, core/extractor.py, core/update.py, core/corr.py
`CorrBlock1D`, core/utils/utils.py `bilinear_sampler`) written out with
plain torch: nn.Conv2d, nn.BatchNorm2d, nn.InstanceNorm2d, F.grid_sample
and F.unfold. It imports nothing of the program under test. State-dict
names are the published module tree's (without DataParallel's `module.`),
so the same weights load here and into the program. Run it under float32
with TF32 off (`configure_numerics`).

The loop is the published one, results never read included: the mask
head runs in every iteration and the pyramid builds corr_levels + 1
levels. Departures from the published code:
- only the settings a configuration of the benchmark uses are written:
  three GRU levels, the "reg" correlation, no shared backbone, no
  slow-fast GRU, no mixed precision, the feature encoder's instance norm
  and the context encoder's batch norm, eval mode;
- images enter as (B, H, W, 3) in [0, 255] (the harness's frames) and the
  output is the demo's disparity, minus the upsampled flow's x, (B, H, W,
  1), of the last iteration only (test_mode);
- `Conv2d.tf32` (never set in the reference itself, only in the
  lower-precision control) rounds each conv's input and weight to TF32,
  as does `RAFTStereo.tf32` the correlation's features.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def configure_numerics():
    """Plain float32: no TF32 in matrix products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(t):
    """float32 t rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero), as the tensor cores read a TF32 operand."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class Conv2d(nn.Conv2d):
    """nn.Conv2d; with `tf32` set, on TF32-rounded input and weight."""

    tf32 = False

    def forward(self, x):
        if self.tf32:
            return self._conv_forward(round_tf32(x), round_tf32(self.weight), self.bias)
        return super().forward(x)


def norm_layer(norm_fn, planes):
    return nn.BatchNorm2d(planes) if norm_fn == "batch" else nn.InstanceNorm2d(planes)


# ------------------------------------------------------------ core/extractor.py

class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm_fn, stride=1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, kernel_size=3, padding=1, stride=stride)
        self.conv2 = Conv2d(planes, planes, kernel_size=3, padding=1)
        self.relu = nn.ReLU()
        self.norm1 = norm_layer(norm_fn, planes)
        self.norm2 = norm_layer(norm_fn, planes)
        if not (stride == 1 and in_planes == planes):
            self.norm3 = norm_layer(norm_fn, planes)
        if stride == 1 and in_planes == planes:
            self.downsample = None
        else:
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, kernel_size=1, stride=stride), self.norm3)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim, norm_fn, downsample):
        super().__init__()
        self.norm1 = norm_layer(norm_fn, 64)
        self.conv1 = Conv2d(3, 64, kernel_size=7, stride=1 + (downsample > 2), padding=3)
        self.relu1 = nn.ReLU()
        self.in_planes = 64
        self.layer1 = self._make_layer(64, norm_fn, stride=1)
        self.layer2 = self._make_layer(96, norm_fn, stride=1 + (downsample > 1))
        self.layer3 = self._make_layer(128, norm_fn, stride=1 + (downsample > 0))
        self.conv2 = Conv2d(128, output_dim, kernel_size=1)

    def _make_layer(self, dim, norm_fn, stride=1):
        layer1 = ResidualBlock(self.in_planes, dim, norm_fn, stride=stride)
        layer2 = ResidualBlock(dim, dim, norm_fn, stride=1)
        self.in_planes = dim
        return nn.Sequential(layer1, layer2)

    def forward(self, x):
        """x: a list of (B, 3, H, W) images, run as one batch and split."""
        batch_dim = x[0].shape[0]
        x = torch.cat(x, dim=0)
        x = self.relu1(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x).split(split_size=batch_dim, dim=0)


class MultiBasicEncoder(nn.Module):
    def __init__(self, output_dim, norm_fn, downsample):
        super().__init__()
        self.norm1 = norm_layer(norm_fn, 64)
        self.conv1 = Conv2d(3, 64, kernel_size=7, stride=1 + (downsample > 2), padding=3)
        self.relu1 = nn.ReLU()
        self.in_planes = 64
        self.layer1 = self._make_layer(64, norm_fn, stride=1)
        self.layer2 = self._make_layer(96, norm_fn, stride=1 + (downsample > 1))
        self.layer3 = self._make_layer(128, norm_fn, stride=1 + (downsample > 0))
        self.layer4 = self._make_layer(128, norm_fn, stride=2)
        self.layer5 = self._make_layer(128, norm_fn, stride=2)
        self.outputs08 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, stride=1),
                          Conv2d(128, dim[2], 3, padding=1)) for dim in output_dim)
        self.outputs16 = nn.ModuleList(
            nn.Sequential(ResidualBlock(128, 128, norm_fn, stride=1),
                          Conv2d(128, dim[1], 3, padding=1)) for dim in output_dim)
        self.outputs32 = nn.ModuleList(Conv2d(128, dim[0], 3, padding=1) for dim in output_dim)

    _make_layer = BasicEncoder._make_layer

    def forward(self, x):
        x = self.relu1(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        outputs08 = [f(x) for f in self.outputs08]
        y = self.layer4(x)
        outputs16 = [f(y) for f in self.outputs16]
        z = self.layer5(y)
        outputs32 = [f(z) for f in self.outputs32]
        return outputs08, outputs16, outputs32


# --------------------------------------------------------------- core/update.py

class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256, output_dim=2):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = Conv2d(hidden_dim, output_dim, 3, padding=1)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.conv2(self.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim, input_dim, kernel_size=3):
        super().__init__()
        self.convz = Conv2d(hidden_dim + input_dim, hidden_dim, kernel_size,
                            padding=kernel_size // 2)
        self.convr = Conv2d(hidden_dim + input_dim, hidden_dim, kernel_size,
                            padding=kernel_size // 2)
        self.convq = Conv2d(hidden_dim + input_dim, hidden_dim, kernel_size,
                            padding=kernel_size // 2)

    def forward(self, h, cz, cr, cq, *x_list):
        x = torch.cat(x_list, dim=1)
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_levels, corr_radius):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1)
        self.convc1 = Conv2d(cor_planes, 64, 1, padding=0)
        self.convc2 = Conv2d(64, 64, 3, padding=1)
        self.convf1 = Conv2d(2, 64, 7, padding=3)
        self.convf2 = Conv2d(64, 64, 3, padding=1)
        self.conv = Conv2d(64 + 64, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc1(corr))
        cor = F.relu(self.convc2(cor))
        flo = F.relu(self.convf1(flow))
        flo = F.relu(self.convf2(flo))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


def pool2x(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1)


def interp(x, dest):
    return F.interpolate(x, dest.shape[2:], mode="bilinear", align_corners=True)


class BasicMultiUpdateBlock(nn.Module):
    def __init__(self, cfg, hidden_dims):
        super().__init__()
        self.encoder = BasicMotionEncoder(cfg["corr_levels"], cfg["corr_radius"])
        encoder_output_dim = 128
        self.gru08 = ConvGRU(hidden_dims[2], encoder_output_dim + hidden_dims[1])
        self.gru16 = ConvGRU(hidden_dims[1], hidden_dims[0] + hidden_dims[2])
        self.gru32 = ConvGRU(hidden_dims[0], hidden_dims[1])
        self.flow_head = FlowHead(hidden_dims[2], hidden_dim=256, output_dim=2)
        factor = 2 ** cfg["n_downsample"]
        self.mask = nn.Sequential(
            Conv2d(hidden_dims[2], 256, 3, padding=1), nn.ReLU(),
            Conv2d(256, (factor ** 2) * 9, 1, padding=0))

    def forward(self, net, inp, corr, flow):
        net[2] = self.gru32(net[2], *(inp[2]), pool2x(net[1]))
        net[1] = self.gru16(net[1], *(inp[1]), pool2x(net[0]), interp(net[2], net[1]))
        motion_features = self.encoder(flow, corr)
        net[0] = self.gru08(net[0], *(inp[0]), motion_features, interp(net[1], net[0]))
        delta_flow = self.flow_head(net[0])
        mask = .25 * self.mask(net[0])  # scale mask to balance gradients
        return net, mask, delta_flow


# ----------------------------------------------------------------- core/corr.py

def bilinear_sampler(img, coords):
    """grid_sample in pixel coordinates (align_corners=True, zero padding)."""
    H, W = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (W - 1) - 1
    if H > 1:
        ygrid = 2 * ygrid / (H - 1) - 1
    grid = torch.cat([xgrid, ygrid], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


class CorrBlock1D:
    def __init__(self, fmap1, fmap2, num_levels=4, radius=4, tf32=False):
        self.num_levels = num_levels
        self.radius = radius
        self.corr_pyramid = []
        corr = CorrBlock1D.corr(fmap1, fmap2, tf32)
        batch, h1, w1, _, w2 = corr.shape
        corr = corr.reshape(batch * h1 * w1, 1, 1, w2)
        self.corr_pyramid.append(corr)
        for _ in range(self.num_levels):
            corr = F.avg_pool2d(corr, [1, 2], stride=[1, 2])
            self.corr_pyramid.append(corr)

    def __call__(self, coords):
        r = self.radius
        coords = coords[:, :1].permute(0, 2, 3, 1)
        batch, h1, w1, _ = coords.shape
        out_pyramid = []
        for i in range(self.num_levels):
            corr = self.corr_pyramid[i]
            dx = torch.linspace(-r, r, 2 * r + 1)
            dx = dx.view(2 * r + 1, 1).to(coords.device)
            x0 = dx + coords.reshape(batch * h1 * w1, 1, 1, 1) / 2 ** i
            y0 = torch.zeros_like(x0)
            coords_lvl = torch.cat([x0, y0], dim=-1)
            corr = bilinear_sampler(corr, coords_lvl)
            out_pyramid.append(corr.view(batch, h1, w1, -1))
        out = torch.cat(out_pyramid, dim=-1)
        return out.permute(0, 3, 1, 2).contiguous().float()

    @staticmethod
    def corr(fmap1, fmap2, tf32=False):
        B, D, H, W1 = fmap1.shape
        _, _, _, W2 = fmap2.shape
        if tf32:
            fmap1, fmap2 = round_tf32(fmap1), round_tf32(fmap2)
        corr = torch.einsum("aijk,aijh->ajkh", fmap1, fmap2)
        corr = corr.reshape(B, H, W1, 1, W2).contiguous()
        return corr / torch.sqrt(torch.tensor(D).float())


# ----------------------------------------------------------- core/raft_stereo.py

def coords_grid(batch, ht, wd, device):
    coords = torch.meshgrid(torch.arange(ht, device=device), torch.arange(wd, device=device),
                            indexing="ij")
    coords = torch.stack(coords[::-1], dim=0).float()
    return coords[None].repeat(batch, 1, 1, 1)


class RAFTStereo(nn.Module):
    """`cfg` is a mapping with the published arguments hidden_dims,
    n_gru_layers (3), n_downsample, corr_levels, corr_radius,
    corr_implementation ("reg"), context_norm ("batch"), shared_backbone
    (False), slow_fast_gru (False), mixed_precision (False) and iters; it
    refuses other values of those in brackets."""

    tf32 = False

    def __init__(self, cfg):
        super().__init__()
        self.cfg = dict(cfg)
        if (self.cfg["n_gru_layers"] != 3 or self.cfg["corr_implementation"] != "reg"
                or self.cfg["context_norm"] != "batch" or self.cfg["shared_backbone"] or self.cfg["slow_fast_gru"]
                or self.cfg["mixed_precision"]):
            raise ValueError(f"the reference writes out only the settings the benchmark "
                             f"uses, not {self.cfg}")
        hidden_dims = context_dims = list(self.cfg["hidden_dims"])
        self.cnet = MultiBasicEncoder(output_dim=[hidden_dims, context_dims],
                                      norm_fn=self.cfg["context_norm"],
                                      downsample=self.cfg["n_downsample"])
        self.update_block = BasicMultiUpdateBlock(self.cfg, hidden_dims=hidden_dims)
        self.context_zqr_convs = nn.ModuleList(
            Conv2d(context_dims[i], hidden_dims[i] * 3, 3, padding=3 // 2) for i in range(3))
        self.fnet = BasicEncoder(output_dim=256, norm_fn="instance",
                                 downsample=self.cfg["n_downsample"])

    def upsample_flow(self, flow, mask):
        """Flow at 1/factor -> full resolution by a convex combination."""
        N, D, H, W = flow.shape
        factor = 2 ** self.cfg["n_downsample"]
        mask = mask.view(N, 1, 9, factor, factor, H, W)
        mask = torch.softmax(mask, dim=2)
        up_flow = F.unfold(factor * flow, [3, 3], padding=1)
        up_flow = up_flow.view(N, D, 9, 1, 1, H, W)
        up_flow = torch.sum(mask * up_flow, dim=2)
        up_flow = up_flow.permute(0, 1, 4, 2, 5, 3)
        return up_flow.reshape(N, D, factor * H, factor * W)

    def forward(self, img0, img1, iters=None):
        """img0/img1: (B, H, W, 3) in [0, 255], H and W multiples of 32.
        Returns the disparity (B, H, W, 1) after `iters` iterations."""
        iters = self.cfg["iters"] if iters is None else iters
        image1 = (2 * (img0.permute(0, 3, 1, 2) / 255.0) - 1.0).contiguous()
        image2 = (2 * (img1.permute(0, 3, 1, 2) / 255.0) - 1.0).contiguous()

        cnet_list = self.cnet(image1)
        fmap1, fmap2 = self.fnet([image1, image2])
        net_list = [torch.tanh(x[0]) for x in cnet_list]
        inp_list = [torch.relu(x[1]) for x in cnet_list]
        inp_list = [list(conv(i).split(split_size=conv.out_channels // 3, dim=1))
                    for i, conv in zip(inp_list, self.context_zqr_convs)]

        corr_fn = CorrBlock1D(fmap1.float(), fmap2.float(), radius=self.cfg["corr_radius"],
                              num_levels=self.cfg["corr_levels"], tf32=self.tf32)
        N, _, H, W = net_list[0].shape
        coords0 = coords_grid(N, H, W, image1.device)
        coords1 = coords_grid(N, H, W, image1.device)

        for _ in range(iters):
            corr = corr_fn(coords1)
            flow = coords1 - coords0
            net_list, up_mask, delta_flow = self.update_block(net_list, inp_list, corr, flow)
            delta_flow[:, 1] = 0.0
            coords1 = coords1 + delta_flow
        flow_up = self.upsample_flow(coords1 - coords0, up_mask)[:, :1]
        return -flow_up.permute(0, 2, 3, 1)
