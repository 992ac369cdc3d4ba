"""Global and local disparity refiners (reference: src/s2m2/core/model/refinenet.py).

Precision: the 1-channel disp/conf/occ state is carried in float32 through
the whole refinement chain; only the conv and UNet features run in the
compute dtype (as in `s2m2_tpu/models/refiners.py`).
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers
from .cost_volume import cost_volume_lookup
from .layers import Conv, mlp2
from .unet import UNet


class ConvGRU(nn.Module):
    """Separable 2-pass ConvGRU: kx1 gates then 1xk gates (reference: refinenet.py:7-36)."""

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
        return h.to(x.dtype)


class GlobalRefiner(nn.Module):
    """Confidence-gated inpainting of low-confidence regions
    (reference: refinenet.py:39-73)."""

    def __init__(self, c):
        super().__init__()
        self.init_feat = mlp2(2 + c, c, c, 3, 1)
        self.refine_unet = UNet([c, c, c], 1, False, 1)
        self.out_feat = nn.Sequential(Conv(c, 1, 3))

    def forward(self, ctx, disp, conf):
        disp = disp.float()
        conf = conf.float()
        mask = (conf > 0.2).float()
        conf_logit = layers.logit(mask * conf, eps=1e-1)
        feat = torch.cat([(disp / 1e2 * mask).to(ctx.dtype), conf_logit.to(ctx.dtype),
                          ctx], dim=1)
        refine_feat = self.refine_unet(self.init_feat(feat))[0]
        disp_update = self.out_feat(refine_feat).float() * 1e2
        return mask * disp + (1 - mask) * disp_update


class LocalRefiner(nn.Module):
    """One RAFT-style update step (reference: refinenet.py:76-154)."""

    def __init__(self, c, dims, e, radius):
        super().__init__()
        taps = 2 * radius + 1
        self.disp_feat = mlp2(1, 96, 96, 3, 3)
        self.corr_feat1 = mlp2(taps, 96, 64, 1, 1)
        self.corr_feat2 = mlp2(taps, 96, 64, 1, 1)
        self.conf_occ_feat = mlp2(2, 64, 32, 3, 1)
        self.disp_corr_ctx_cat = mlp2(256 + c, 2 * c, c, 1, 3)
        self.refine_unet = UNet(dims, e, False, 1)
        self.disp_update = mlp2(c, c, 1, 3, 3, bias2=False)
        self.conf_occ_update = mlp2(c, c, 2, 3, 3, bias2=False)
        self.gru = ConvGRU(c)

    def forward(self, hidden, ctx, disp, conf, occ, cv_state):
        """Returns (hidden, disp, conf, occ) at 1/4 resolution; disp, conf and
        occ in float32, hidden in the compute dtype."""
        cdt = ctx.dtype
        disp = disp.float()
        conf_logit = layers.logit(conf.float(), eps=1e-2)
        occ_logit = layers.logit(occ.float(), eps=1e-2)
        corr1, corr2 = cost_volume_lookup(cv_state, disp)
        # in the JAX package's order, which is the int8 sites' order
        corr_feat1 = self.corr_feat1(corr1.to(cdt) / 16)
        corr_feat2 = self.corr_feat2(corr2.to(cdt) / 16)
        disp_feat = self.disp_feat((disp / 1e2).to(cdt))
        conf_feat = self.conf_occ_feat(torch.cat([conf_logit, occ_logit], dim=1).to(cdt))
        cat = torch.cat([disp_feat, corr_feat1, corr_feat2, ctx, conf_feat], dim=1)
        feat = self.disp_corr_ctx_cat(cat.to(cdt))
        refine_feat = self.refine_unet(feat)[0]
        hidden_new = self.gru(hidden, refine_feat)
        disp_update = self.disp_update(hidden_new)
        conf_occ = self.conf_occ_update(hidden_new).float()
        conf_new = torch.sigmoid(conf_occ[:, 0:1] + conf_logit)
        occ_new = torch.sigmoid(conf_occ[:, 1:2] + occ_logit)
        disp_new = disp + disp_update.float()
        return hidden_new.to(cdt), disp_new, conf_new, occ_new
