"""S2M2 full forward pass (reference: src/s2m2/core/model/s2m2.py).

Activations are NCHW inside; the left and right views travel
batch-concatenated ((2B, C, H, W), left half first) through the shared
feature trunk, as in the reference. At the public boundary the layouts are
the JAX package's: images (B, H, W, 3) in [0, 255] with H and W multiples of
32, outputs (disp, occ, conf), each (B, H, W, 1) at input resolution (twice
that under output_upsample). The compute dtype is the images' dtype.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from .cost_volume import make_cost_volume
from .encoder import CNNEncoder
from .feature_fusion import FeatureFusion
from .layers import mlp2
from .matching import DispInit
from .mrt import StackedMRT
from .refiners import GlobalRefiner, LocalRefiner
from .unet import UNet
from .upsampling import (UpsampleMask1x, UpsampleMask4x, upsample1x,
                         upsample1x_multi, upsample4x)


def normalize_img(img):
    """[0,255] -> [-1,1] (reference: s2m2.py:80-89)."""
    return (img / 255.0 - 0.5) * 2.0


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class S2M2(nn.Module):
    """The whole model; `state_dict()` keys equal the reference's."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.feature_channels
        e = cfg.dim_expansion
        dims = list(cfg.unet_dims)
        self.cnn_backbone = CNNEncoder(c)
        self.feat_pyramid = UNet(dims, e, True, cfg.num_transformer * 2,
                                 pe_dim=cfg.pe_dim)
        self.transformer = StackedMRT(dims, cfg.num_transformer, cfg.num_heads, e)
        self.disp_init = DispInit(c)
        self.upsample_mask_1x = UpsampleMask1x(c)
        self.upsample_mask_4x_refine = UpsampleMask4x(c)
        self.global_refiner = GlobalRefiner(c)
        self.feat_fusion_layer = FeatureFusion(c, 3)
        self.refiner = LocalRefiner(c, dims, e, cfg.radius)
        self.ctx_feat = mlp2(c, c, c, 1, 1)

    def forward(self, img0, img1, return_aux: bool = False):
        """img0/img1: (B, H, W, 3) in [0,255], H % 32 == W % 32 == 0.

        return_aux=True also returns {'disp_seq': [...]}, the per-iteration
        disparities at 1/4 resolution ((B, H/4, W/4, 1), in full-resolution
        pixel units, the OT/global-refined init first)."""
        cfg = self.cfg
        img0_nor = normalize_img(img0.permute(0, 3, 1, 2))
        img1_nor = normalize_img(img1.permute(0, 3, 1, 2))

        feature_4x, feature_2x = self.cnn_backbone(torch.cat([img0_nor, img1_nor], 0))
        feature0_2x = feature_2x.chunk(2, dim=0)[0]

        py_4x, py_8x, py_16x, py_32x = self.feat_pyramid(feature_4x)
        feature_tr_4x = self.transformer(py_4x, py_8x, py_16x, py_32x)

        disp, conf, occ, cv = self.disp_init(
            feature_tr_4x, ot_iter=cfg.ot_iter, use_positivity=cfg.use_positivity)

        feature0_tr_4x = feature_tr_4x.chunk(2, dim=0)[0]
        feature0_py_4x = py_4x.chunk(2, dim=0)[0]

        disp = self.global_refiner(feature0_tr_4x, disp, conf)
        if cfg.use_positivity:
            disp = disp.clamp(min=0)

        feature0_fusion_4x = self.feat_fusion_layer(feature0_tr_4x, feature0_py_4x)
        ctx0 = self.ctx_feat(feature0_fusion_4x)
        hidden = torch.tanh(ctx0)

        w4 = feature0_fusion_4x.shape[3]
        cv_state = make_cost_volume(cv, radius=cfg.radius)
        coords_4x = torch.arange(w4, dtype=torch.float32, device=disp.device)

        disp_seq = [disp * 4]
        for _ in range(cfg.refine_iter):
            hidden, disp, conf, occ = self.refiner(hidden, ctx0, disp, conf, occ,
                                                   cv_state)
            if cfg.use_positivity:
                disp = disp.clamp(min=0)
            # geometric occlusion mask: the matched coordinate stays on-image
            occ = occ * ((coords_4x - disp) >= 0)
            disp_seq.append(disp * 4)

        mask = self.upsample_mask_4x_refine(hidden, feature0_2x)
        full = upsample4x(torch.cat([disp * 4, occ, conf], dim=1), mask)
        filt = self.upsample_mask_1x(full[:, 0:1].to(img0_nor.dtype), img0_nor,
                                     feature0_2x)
        if cfg.output_upsample:
            disp_up = 2 * upsample1x(full[:, 0:1], filt, True)
            occ_up = upsample1x(full[:, 1:2], filt, True)
            conf_up = upsample1x(full[:, 2:3], filt, True)
        else:
            out = upsample1x_multi(full, filt)
            disp_up, occ_up, conf_up = out[:, 0:1], out[:, 1:2], out[:, 2:3]

        outs = (_nhwc(disp_up), _nhwc(occ_up), _nhwc(conf_up))
        if return_aux:
            return (*outs, {"disp_seq": [_nhwc(d) for d in disp_seq]})
        return outs

