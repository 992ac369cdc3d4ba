"""Gated feature fusion (reference: src/s2m2/core/model/feature_fusion.py)."""
from __future__ import annotations

import torch
from torch import nn

from . import layers


class FeatureFusion(nn.Module):
    """out = fusion(cat) + w*z0 + (1-w)*z1 with w = clamp(sigmoid(gate), .01, .99)."""

    def __init__(self, d, k, use_gate=True):
        super().__init__()
        self.feature_fusion = layers.mlp2(2 * d, 2 * d, d, k, 1)
        if use_gate:
            self.feature_gate = layers.mlp2(2 * d, d, d, k, 1)

    def forward(self, z0, z1):
        z = torch.cat([z0, z1], dim=1)
        fused = self.feature_fusion(z)
        if not hasattr(self, "feature_gate"):
            return fused
        w = torch.sigmoid(self.feature_gate(z)).clamp(0.01, 0.99)
        return fused + w * z0 + (1.0 - w) * z1
