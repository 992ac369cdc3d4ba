"""s2m2_torch — the S2M2 stereo engine in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `s2m2_tpu`, which stays in the repository as the
numerical reference. Public entry point:
`s2m2_torch.runtime.engine.StereoEngine`.
"""
from .config import ModelConfig, Precision, VARIANTS, get_config  # noqa: F401

__version__ = "0.1.0"
