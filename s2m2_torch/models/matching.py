"""Optimal-transport disparity initialization
(reference: src/s2m2/core/model/submodules.py:147-243).

Per epipolar row: W x W left/right correlation, log-space Sinkhorn with a
dustbin row and column (`ops.sinkhorn`, kernel C on a card), then a windowed
soft-argmax around the per-row argmax, giving (disparity, confidence,
occlusion) at 1/4 resolution in float32, plus the raw correlation volume
the refiner reuses.
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers
from .layers import Norm
from ..ops.sinkhorn import fused_correlation_ot


class DispInit(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.layer_norm = Norm(c)

    def forward(self, feature, *, ot_iter=3, use_positivity=True, window=2):
        """feature: (2B, C, H, W), left half then right half on the batch.

        Returns disparity, conf, occ, each (B, 1, H, W) float32, and the raw
        pre-OT correlation cv (B, H, W, W) in the feature dtype."""
        w = feature.shape[3]
        feat = layers.layer_norm(feature.permute(0, 2, 3, 1), self.layer_norm.weight,
                                 self.layer_norm.bias)
        f0, f1 = (f.contiguous() for f in feat.chunk(2, dim=0))
        masked_prob, cv = fused_correlation_ot(f0, f1, ot_iter=ot_iter,
                                               use_positivity=use_positivity)
        # windowed soft-argmax, +-window around the row-wise argmax
        # (reference: submodules.py:226-239), as one masked reduction
        mp32 = masked_prob.float()
        ind = mp32.argmax(dim=3, keepdim=True)
        j = torch.arange(w, device=feature.device)
        in_window = ((j - ind).abs() <= window).float()
        conf = (mp32 * in_window).sum(dim=3, keepdim=True)
        corr = (mp32 * in_window * j.float()).sum(dim=3, keepdim=True)
        eps = 1e-4
        corr = (corr + eps) / (conf + eps)
        disparity = j.float().view(1, 1, w, 1) - corr
        occ = mp32.sum(dim=3, keepdim=True)
        return _nchw(disparity), _nchw(conf), _nchw(occ), cv


def _nchw(t):
    return t.permute(0, 3, 1, 2).contiguous()
