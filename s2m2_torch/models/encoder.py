"""Shallow CNN feature stem (reference: src/s2m2/core/model/submodules.py:63-93).

The plain form of `s2m2_tpu.models.encoder.cnn_encoder_unpacked`: the
JAX package's space-to-depth rewrites fit the TPU's 128-lane matrix unit
and compute the same function. Its int8 sites are the packed stem's.
"""
from __future__ import annotations

from torch import nn

from . import layers
from .layers import Conv, Norm


class CNNEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv0 = layers.mlp2(3, 16, 16, 1, 1)
        self.conv1_down = nn.Sequential(Conv(16, 64, 5, stride=2), nn.GELU(),
                                        Conv(64, c, 3))
        # int8 sites are judged on the JAX package's packed stem
        # (s2m2_tpu/models/encoder.py:38-47): pack_pointwise_s2d (2, 2, 3, 64),
        # pack_pointwise (1, 1, 64, 64), pack_strided_conv (3, 3, 64, 64)
        self.conv0[0].site_gate = (4 * 3, 3, 4 * 16)
        self.conv0[2].site_gate = (4 * 16, 4 * 16, 4 * 16)
        self.conv1_down[0].site_gate = (9 * 4 * 16, 4 * 16, 64)
        self.norm1 = Norm(c)
        self.conv2 = layers.mlp2(c, c, c, 3, 3)
        self.conv2_down = nn.Sequential(Conv(c, c, 3, stride=2))

    def forward(self, x):
        """x: (B, 3, H, W) normalized images. Returns (x_4x, x_2x)."""
        d = self.conv1_down(self.conv0(x))
        x_2x = layers.group_norm(d, self.norm1.weight, self.norm1.bias, num_groups=8)
        x_2x = self.conv2(x_2x) + x_2x
        return self.conv2_down(x_2x), x_2x
