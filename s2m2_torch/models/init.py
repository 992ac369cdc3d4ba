"""Seeded random weights for S2M2 and RAFT-Stereo.

S2M2's draws are made in the JAX package's layouts and order
(`s2m2_tpu/models/init.py`), from one `np.random.default_rng(seed)`, so a
seed gives bit-identical weights in both packages; `tools.convert.from_jax`
then turns them into a torch state dict. RAFT-Stereo, which the JAX package
does not have, draws in its own parameter order (`init_raft_stereo`).
Bounds approximate torch defaults (uniform +-1/sqrt(fan_in)); norms start
at weight 1, bias 0.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig
from ..tools.convert import flatten, from_jax
from .layers import Conv


class _Rng:
    def __init__(self, seed):
        self.g = np.random.default_rng(seed)

    def uniform(self, shape, bound):
        return self.g.uniform(-bound, bound, size=shape).astype(np.float32)


def _conv(rng, cin, cout, k, bias=True):
    kh, kw = (k, k) if isinstance(k, int) else k
    b = 1.0 / np.sqrt(cin * kh * kw)
    p = {"weight": rng.uniform((kh, kw, cin, cout), b)}
    if bias:
        p["bias"] = rng.uniform((cout,), b)
    return p


_convT = _conv  # same storage layout (kh, kw, I, O) in the JAX tree


def _linear(rng, cin, cout, bias=True):
    b = 1.0 / np.sqrt(cin)
    p = {"weight": rng.uniform((cin, cout), b)}
    if bias:
        p["bias"] = rng.uniform((cout,), b)
    return p


def _norm(c):
    return {"weight": np.ones((c,), np.float32), "bias": np.zeros((c,), np.float32)}


def _attn(rng, d, e):
    return {"q": _linear(rng, d, e * d, bias=False),
            "k": _linear(rng, d, e * d, bias=False),
            "v": _linear(rng, d, e * d, bias=True),
            "proj": _linear(rng, e * d, d, bias=False)}


def _self_attn(rng, d, heads, e, use_pe, pe_dim=32):
    p = _attn(rng, d, e)
    if use_pe:
        p["pe_proj"] = _linear(rng, pe_dim, e * d // heads)
    return p


def _ffn(rng, d, e):
    return {"ffn": {"0": _linear(rng, d, e * d), "2": _linear(rng, e * d, d)}}


def _conv_block2d(rng, d, e, k=3):
    return {"convs": {"0": _conv(rng, d, e * d, k), "2": _conv(rng, e * d, d, k)},
            "convs_1x": {"0": _conv(rng, d, e * d, 1), "2": _conv(rng, e * d, d, 1)}}


def _feature_fusion(rng, d, k, use_gate=True):
    p = {"feature_fusion": {"0": _conv(rng, 2 * d, 2 * d, k),
                            "2": _conv(rng, 2 * d, d, 1)}}
    if use_gate:
        p["feature_gate"] = {"0": _conv(rng, 2 * d, d, k), "2": _conv(rng, d, d, 1)}
    return p


def _global_attn_block(rng, d, heads, e, use_cross, use_pe):
    p = {"self_attn": {"attn": _self_attn(rng, d, heads, e, use_pe)},
         "ffn": _ffn(rng, d, e)}
    if use_cross:
        p["cross_attn"] = {"attn": _attn(rng, d, e)}
        p["ffn_c"] = _ffn(rng, d, e)
    return p


def _basic_attn_block(rng, d, heads, e):
    return {"cross_attn": {"attn": _attn(rng, d, e)},
            "self_attn": {"attn": _self_attn(rng, d, heads, e, False)},
            "ffn_c": _ffn(rng, d, e),
            "ffn": _ffn(rng, d, e)}


def _unet(rng, dims, e, use_pe, n_attn, use_gate=True):
    d0, d1, d2 = dims
    return {
        "down_conv0": {"1": _conv(rng, d0, d1, 1)},
        "down_conv1": {"1": _conv(rng, d1, d2, 1)},
        "down_conv2": {"1": _conv(rng, d2, d2, 1)},
        "up_conv0": {"1": _conv(rng, d1, d0, 1)},
        "up_conv1": {"1": _conv(rng, d2, d1, 1)},
        "up_conv2": {"1": _conv(rng, d2, d2, 1)},
        "concat_conv0": _feature_fusion(rng, d0, 1, use_gate),
        "concat_conv1": _feature_fusion(rng, d1, 1, use_gate),
        "concat_conv2": _feature_fusion(rng, d2, 1, use_gate),
        "enc0": _conv_block2d(rng, d0, e),
        "enc1": _conv_block2d(rng, d1, e),
        "enc2": _conv_block2d(rng, d2, e),
        "dec0": _conv_block2d(rng, d0, e),
        "dec1": _conv_block2d(rng, d1, e),
        "dec2": _conv_block2d(rng, d2, e),
        "enc3s": {str(i): _global_attn_block(rng, d2, 8, e, False, use_pe)
                  for i in range(n_attn)},
        "dec3s": {str(i): _global_attn_block(rng, d2, 8, e, False, False)
                  for i in range(n_attn)},
    }


def _mrt(rng, dims, heads, e, use_gate=True):
    d0, d1, d2 = dims
    return {
        "down_conv0": {"1": _conv(rng, d0, d1, 1)},
        "down_conv1": {"1": _conv(rng, d1, d2, 1)},
        "down_conv2": {"1": _conv(rng, d2, d2, 1)},
        "up_conv0": {"1": _conv(rng, d1, d0, 1)},
        "up_conv1": {"1": _conv(rng, d2, d1, 1)},
        "up_conv2": {"1": _conv(rng, d2, d2, 1)},
        "down_concat1": _feature_fusion(rng, d1, 1, use_gate),
        "down_concat2": _feature_fusion(rng, d2, 1, use_gate),
        "down_concat3": _feature_fusion(rng, d2, 1, use_gate),
        "up_concat0": _feature_fusion(rng, d0, 1, use_gate),
        "up_concat1": _feature_fusion(rng, d1, 1, use_gate),
        "up_concat2": _feature_fusion(rng, d2, 1, use_gate),
        "enc_attn0": _basic_attn_block(rng, d0, 1 * heads, e),
        "enc_attn1": _basic_attn_block(rng, d1, 2 * heads, e),
        "enc_attn2": _basic_attn_block(rng, d2, 4 * heads, e),
        "enc_attn3s": {str(i): _global_attn_block(rng, d2, 8 * heads, e, True, False)
                       for i in range(2)},
        "dec_attn0": _basic_attn_block(rng, d0, 1 * heads, e),
        "dec_attn1": _basic_attn_block(rng, d1, 2 * heads, e),
        "dec_attn2": _basic_attn_block(rng, d2, 4 * heads, e),
        "dec_attn3s": {str(i): _global_attn_block(rng, d2, 8 * heads, e, True, False)
                       for i in range(2)},
    }


def init_params_jax_layout(cfg: ModelConfig, seed: int = 0) -> dict:
    """The flat {dotted name: ndarray} weights in the JAX package's layouts."""
    rng = _Rng(seed)
    c = cfg.feature_channels
    e = cfg.dim_expansion
    dims = list(cfg.unet_dims)
    params = {
        "cnn_backbone": {
            "conv0": {"0": _conv(rng, 3, 16, 1), "2": _conv(rng, 16, 16, 1)},
            "conv1_down": {"0": _conv(rng, 16, 64, 5), "2": _conv(rng, 64, c, 3)},
            "norm1": _norm(c),
            "conv2": {"0": _conv(rng, c, c, 3), "2": _conv(rng, c, c, 3)},
            "conv2_down": {"0": _conv(rng, c, c, 3)},
        },
        "feat_pyramid": _unet(rng, dims, e, True, cfg.num_transformer * 2),
        "transformer": {"uformer_list": {
            str(i): _mrt(rng, dims, cfg.num_heads, e)
            for i in range(cfg.num_transformer)}},
        "disp_init": {"layer_norm": _norm(c)},
        "upsample_mask_1x": {
            "conv_disp": {"0": _convT(rng, 1, 16, 3)},
            "conv_rgb": {"0": _convT(rng, 3, 16, 3)},
            "conv_ctx": _convT(rng, c, 16, 2),
            "conv_concat": {"0": _conv(rng, 48, 48, 3), "2": _convT(rng, 48, 9, 1)},
        },
        "upsample_mask_4x_refine": {
            "conv_x": _convT(rng, c, 64, 2),
            "conv_y": _conv(rng, c, 64, 3),
            "conv_concat": {"0": _conv(rng, 128, 128, 3), "2": _convT(rng, 128, 9, 2)},
        },
        "global_refiner": {
            "init_feat": {"0": _conv(rng, 2 + c, c, 3), "2": _conv(rng, c, c, 1)},
            "refine_unet": _unet(rng, [c, c, c], 1, False, 1),
            "out_feat": {"0": _conv(rng, c, 1, 3)},
        },
        "feat_fusion_layer": _feature_fusion(rng, c, 3),
        "refiner": {
            "disp_feat": {"0": _conv(rng, 1, 96, 3), "2": _conv(rng, 96, 96, 3)},
            "corr_feat1": {"0": _conv(rng, 2 * cfg.radius + 1, 96, 1),
                           "2": _conv(rng, 96, 64, 1)},
            "corr_feat2": {"0": _conv(rng, 2 * cfg.radius + 1, 96, 1),
                           "2": _conv(rng, 96, 64, 1)},
            "conf_occ_feat": {"0": _conv(rng, 2, 64, 3), "2": _conv(rng, 64, 32, 1)},
            "disp_corr_ctx_cat": {"0": _conv(rng, 256 + c, 2 * c, 1),
                                  "2": _conv(rng, 2 * c, c, 3)},
            "refine_unet": _unet(rng, dims, e, False, 1),
            "disp_update": {"0": _conv(rng, c, c, 3), "2": _conv(rng, c, 1, 3, bias=False)},
            "conf_occ_update": {"0": _conv(rng, c, c, 3),
                                "2": _conv(rng, c, 2, 3, bias=False)},
            "gru": {
                "convz1": _conv(rng, 2 * c, c, (3, 1)),
                "convr1": _conv(rng, 2 * c, c, (3, 1)),
                "convq1": _conv(rng, 2 * c, c, (3, 1)),
                "convz2": _conv(rng, 2 * c, c, (1, 3)),
                "convr2": _conv(rng, 2 * c, c, (1, 3)),
                "convq2": _conv(rng, 2 * c, c, (1, 3)),
            },
        },
        "ctx_feat": {"0": _conv(rng, c, c, 1), "2": _conv(rng, c, c, 1)},
    }
    return flatten(params)


def init_params(cfg: ModelConfig, seed: int = 0) -> dict:
    """Seeded weights as a torch state dict (torch layouts, float32, CPU)."""
    return from_jax(init_params_jax_layout(cfg, seed))


@torch.no_grad()
def init_raft_stereo(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Fill a `models.raft_stereo.RAFTStereo` in place from one
    `np.random.default_rng(seed)`: each conv's weight, then its bias,
    uniform in +-1/sqrt(fan_in), in the order of `modules()`; batch norms
    at weight 1, bias 0 and running statistics 0 and 1."""
    rng = _Rng(seed)
    for m in model.modules():
        if isinstance(m, Conv):
            bound = 1.0 / np.sqrt(m.weight[0].numel())
            for p in m.parameters(recurse=False):
                p.copy_(torch.from_numpy(rng.uniform(tuple(p.shape), bound)))
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.reset_parameters()
    return model
