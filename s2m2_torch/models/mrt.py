"""Multi-Resolution Transformer and its stack
(reference: src/s2m2/core/model/stacked_MRT.py).

A U-shaped attention encoder/decoder over the 4 pyramid scales. Scales
1x/2x/4x (relative) run scanline attention blocks; the 8x bottleneck runs
2D global attention with cross-view attention. Head counts scale 1/2/4/8
times the base head count.

`fused_block` routes each scanline block whose C and E are at most 512 to
the fused BasicAttnBlock (`ops.fused_block`, kernel D on a card); the rule
is the JAX package's (s2m2_tpu/models/mrt.py:32-38). It is off by default.
"""
from __future__ import annotations

from torch import nn

from ..ops import fused_block as fb
from .attention import BasicAttnBlock, GlobalAttnBlock
from .feature_fusion import FeatureFusion
from .unet import down, global_blocks, up


class MRT(nn.Module):
    def __init__(self, dims, heads, e=1, use_gate=True, fused_block=False):
        super().__init__()
        d0, d1, d2 = dims
        self.down_conv0 = down(d0, d1)
        self.down_conv1 = down(d1, d2)
        self.down_conv2 = down(d2, d2)
        self.up_conv0 = up(d1, d0)
        self.up_conv1 = up(d2, d1)
        self.up_conv2 = up(d2, d2)
        self.down_concat1 = FeatureFusion(d1, 1, use_gate)
        self.down_concat2 = FeatureFusion(d2, 1, use_gate)
        self.down_concat3 = FeatureFusion(d2, 1, use_gate)
        self.up_concat0 = FeatureFusion(d0, 1, use_gate)
        self.up_concat1 = FeatureFusion(d1, 1, use_gate)
        self.up_concat2 = FeatureFusion(d2, 1, use_gate)
        self.enc_attn0 = BasicAttnBlock(d0, 1 * heads, e)
        self.enc_attn1 = BasicAttnBlock(d1, 2 * heads, e)
        self.enc_attn2 = BasicAttnBlock(d2, 4 * heads, e)
        self.enc_attn3s = nn.ModuleList(
            GlobalAttnBlock(d2, 8 * heads, e, use_cross_attn=True) for _ in range(2))
        self.dec_attn0 = BasicAttnBlock(d0, 1 * heads, e)
        self.dec_attn1 = BasicAttnBlock(d1, 2 * heads, e)
        self.dec_attn2 = BasicAttnBlock(d2, 4 * heads, e)
        self.dec_attn3s = nn.ModuleList(
            GlobalAttnBlock(d2, 8 * heads, e, use_cross_attn=True) for _ in range(2))
        self.set_fused_block(fused_block)

    def set_fused_block(self, flag: bool):
        for blk in (self.enc_attn0, self.enc_attn1, self.enc_attn2,
                    self.dec_attn0, self.dec_attn1, self.dec_attn2):
            e, c = blk.ffn.ffn[0].weight.shape
            blk.fused = bool(flag) and fb.supports(c, e)

    def forward(self, z0, z1, z2, z3):
        """One pass over the four scales (reference: stacked_MRT.py:89-133)."""
        z0 = self.enc_attn0(z0)
        z1 = self.enc_attn1(self.down_concat1(z1, self.down_conv0(z0)))
        z2 = self.enc_attn2(self.down_concat2(z2, self.down_conv1(z1)))
        z3 = self.down_concat3(z3, self.down_conv2(z2))
        z3 = global_blocks(z3, self.enc_attn3s, self.dec_attn3s)
        z2 = self.dec_attn2(self.up_concat2(z2, self.up_conv2(z3)))
        z1 = self.dec_attn1(self.up_concat1(z1, self.up_conv1(z2)))
        z0 = self.dec_attn0(self.up_concat0(z0, self.up_conv0(z1)))
        return z0, z1, z2, z3


class StackedMRT(nn.Module):
    """NTR-times repeated MRT; only the top (1/4) scale is consumed
    downstream (reference: stacked_MRT.py:156-166). Keys `uformer_list.<i>.*`."""

    def __init__(self, dims, num_transformer, num_heads=1, e=1, use_gate=True,
                 fused_block=False):
        super().__init__()
        self.uformer_list = nn.ModuleList(
            MRT(dims, num_heads, e, use_gate, fused_block) for _ in range(num_transformer))

    def set_fused_block(self, flag: bool):
        for m in self.uformer_list:
            m.set_fused_block(flag)

    def forward(self, z0, z1, z2, z3):
        for m in self.uformer_list:
            z0, z1, z2, z3 = m(z0, z1, z2, z3)
        return z0
