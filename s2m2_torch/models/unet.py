"""4-scale conv U-Net with a global-attention bottleneck
(reference: src/s2m2/core/model/unet.py).

Used as the feature pyramid over the 1/4 features (use_pe=True,
n_attn=2*NTR) and as the trunk of the global and local refiners
(use_pe=False, n_attn=1). Returns all four decoder scales.
"""
from __future__ import annotations

from torch import nn

from . import layers
from .attention import ConvBlock2D, GlobalAttnBlock
from .feature_fusion import FeatureFusion
from .layers import Conv
from .pe import pe_tables
from ..parallel import band


class _Resample(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def down(cin, cout):
    """AvgPool2 + 1x1 conv (reference: unet.py:25-30); keys `<name>.1.*`."""
    return nn.Sequential(_Resample(layers.avg_pool2d), Conv(cin, cout, 1))


def up(cin, cout):
    """Bilinear x2 (align_corners=False) + 1x1 conv (reference: unet.py:32-37)."""
    return nn.Sequential(_Resample(layers.upsample2x_bilinear), Conv(cin, cout, 1))


def global_blocks(z3, first, then, pe_dim=None):
    """The 1/32 bottleneck's global-attention blocks, `first` (with the
    relative PE when pe_dim is given) then `then`, over all h*w tokens.
    Under band sharding the band's rows are gathered into the full map
    first, every rank runs the blocks on it, and keeps its rows after them;
    the PE tables are the full map's."""
    h_local = z3.shape[2]
    if band.active():
        z3 = band.all_gather_rows(z3)
    pe = None if pe_dim is None else pe_tables(z3.shape[2], z3.shape[3], pe_dim, z3.device)
    for blk in first:
        z3 = blk(z3) if pe is None else blk(z3, pe)
    for blk in then:
        z3 = blk(z3)
    return band.rows_of(z3, h_local) if band.active() else z3


class UNet(nn.Module):
    def __init__(self, dims, e, use_pe, n_attn, use_gate=True, pe_dim=32,
                 bottleneck_heads=8):
        super().__init__()
        d0, d1, d2 = dims
        self.use_pe = use_pe
        self.pe_dim = pe_dim
        self.down_conv0 = down(d0, d1)
        self.down_conv1 = down(d1, d2)
        self.down_conv2 = down(d2, d2)
        self.up_conv0 = up(d1, d0)
        self.up_conv1 = up(d2, d1)
        self.up_conv2 = up(d2, d2)
        self.concat_conv0 = FeatureFusion(d0, 1, use_gate)
        self.concat_conv1 = FeatureFusion(d1, 1, use_gate)
        self.concat_conv2 = FeatureFusion(d2, 1, use_gate)
        self.enc0 = ConvBlock2D(d0, e)
        self.enc1 = ConvBlock2D(d1, e)
        self.enc2 = ConvBlock2D(d2, e)
        self.dec0 = ConvBlock2D(d0, e)
        self.dec1 = ConvBlock2D(d1, e)
        self.dec2 = ConvBlock2D(d2, e)
        # enc3s carry the relative PE; dec3s do not (reference: unet.py:46-63)
        self.enc3s = nn.ModuleList(
            GlobalAttnBlock(d2, bottleneck_heads, e, use_pe=use_pe)
            for _ in range(n_attn))
        self.dec3s = nn.ModuleList(
            GlobalAttnBlock(d2, bottleneck_heads, e) for _ in range(n_attn))

    def forward(self, z):
        """z: (B, C, H, W) at the U-Net's top scale. Returns the 4 decoder
        scales (1x, 2x, 4x, 8x relative downsampling)."""
        z0 = self.enc0(z)
        z1 = self.enc1(self.down_conv0(z0))
        z2 = self.enc2(self.down_conv1(z1))
        z3 = self.down_conv2(z2)
        z3 = global_blocks(z3, self.enc3s, self.dec3s, self.pe_dim if self.use_pe else None)
        z2n = self.dec2(self.concat_conv2(z2, self.up_conv2(z3)))
        z1n = self.dec1(self.concat_conv1(z1, self.up_conv1(z2n)))
        z0n = self.dec0(self.concat_conv0(z0, self.up_conv0(z1n)))
        return z0n, z1n, z2n, z3
