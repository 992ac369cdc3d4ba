"""Model configurations and the S2M2 variant registry (reference:
src/s2m2/core/utils/model_utils.py:12-17 and src/s2m2/core/model/s2m2.py:14-28).

Two architectures run through `runtime.engine.StereoEngine`: S2M2
(`ModelConfig`) and RAFT-Stereo (`RaftStereoConfig`); each configuration
names its own in the class attribute `architecture` (not a dataclass field).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyper-parameters of one S2M2 variant.

    feature_channels: base channel width C (CH in checkpoint names).
    num_transformer:  number of stacked MRT repeats (NTR in checkpoint names).
    dim_expansion:    inner-width multiplier for attention/FFN/conv blocks.
    use_positivity:   clamp disparity >= 0 and mask the cost volume upper triangle.
    output_upsample:  extra 2x output upsampling of the 1x edge-guided filter.
    refine_iter:      iterations of the local (RAFT-style) refiner.
    num_heads:        base head count of the MRT scanline attention (scales 1/2/4/8x).
    ot_iter:          Sinkhorn iterations of the optimal-transport matcher.
    radius:           cost-volume lookup radius (9 taps = 2*radius+1).
    pe_dim:           channel width of the sinc relative positional encoding.
    """

    architecture = "s2m2"  # a class attribute, not a field: no config sets it

    feature_channels: int
    num_transformer: int
    dim_expansion: int = 1
    use_positivity: bool = True
    output_upsample: bool = False
    refine_iter: int = 3
    num_heads: int = 1
    ot_iter: int = 3
    radius: int = 4
    pe_dim: int = 32

    @property
    def ch(self) -> int:
        return self.feature_channels

    @property
    def unet_dims(self) -> tuple:
        c = self.feature_channels
        return (c, c, 2 * c)


VARIANTS = {
    "S": dict(feature_channels=128, num_transformer=1),
    "M": dict(feature_channels=192, num_transformer=2),
    "L": dict(feature_channels=256, num_transformer=3),
    "XL": dict(feature_channels=384, num_transformer=3),
}


def get_config(model_type: str, *, use_positivity: bool = True, refine_iter: int = 3,
               output_upsample: bool = False) -> ModelConfig:
    if model_type not in VARIANTS:
        raise ValueError(
            f"model type should be one of {sorted(VARIANTS)}, got {model_type!r}")
    v = VARIANTS[model_type]
    return ModelConfig(feature_channels=v["feature_channels"],
                       num_transformer=v["num_transformer"],
                       use_positivity=use_positivity,
                       refine_iter=refine_iter,
                       output_upsample=output_upsample)


@dataclasses.dataclass(frozen=True)
class RaftStereoConfig:
    """Hyper-parameters of RAFT-Stereo (arXiv:2109.07547), under the names
    of the published code's arguments (github.com/princeton-vl/RAFT-Stereo,
    train_stereo.py); the defaults are its own, with `iters` its evaluation
    default `valid_iters`.

    hidden_dims:   GRU hidden widths at 1/4f, 1/2f, 1/f of the input,
                   f = 2**n_downsample (128, 128, 128).
    n_downsample:  the feature and context maps are at 1/2**n_downsample.
    corr_levels:   levels of the 1-D correlation pyramid.
    corr_radius:   taps either side of the match in each level (2r + 1).
    iters:         GRU iterations a forward.

    The port runs the published defaults of the other arguments and has no
    field for them: three GRU levels, the "reg" correlation, batch norm in
    the context encoder, no shared backbone, no slow-fast GRU, no mixed
    precision."""

    architecture = "raft_stereo"  # not a field: no config sets it

    hidden_dims: tuple = (128, 128, 128)
    n_downsample: int = 2
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 32

    def __post_init__(self):
        object.__setattr__(self, "hidden_dims", tuple(self.hidden_dims))
        if len(self.hidden_dims) != 3 or self.iters < 1 or self.corr_levels < 1:
            raise ValueError(f"RaftStereoConfig: hidden_dims {self.hidden_dims} must give "
                             "3 widths; iters, corr_levels >= 1")


def checkpoint_name(cfg: ModelConfig) -> str:
    """Checkpoint file stem, e.g. CH128NTR1 (reference: model_utils.py:27)."""
    return f"CH{cfg.feature_channels}NTR{cfg.num_transformer}"


@dataclasses.dataclass(frozen=True)
class Precision:
    """Mixed-precision policy.

    compute_dtype is used for convs and matmuls; normalization statistics,
    softmax, Sinkhorn log-sums, the soft-argmax division and logits always
    run in float32 (reference: model_utils.py:76, submodules.py:147-152).
    """

    compute_dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @staticmethod
    def bf16() -> "Precision":
        return Precision(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16)

    @staticmethod
    def fp32() -> "Precision":
        return Precision()
