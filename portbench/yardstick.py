"""The benchmark's fixed arithmetic: peaks of the card, the kernel families
of a device trace, and a model's FLOPs counted over its plain reference.

Copied from chip_smoke.py (`PEAK_*`, `FAMILIES`) so that a change to the
program cannot move the yardstick. What an architecture's own kernels must
do (their shapes, operations and bytes) is its file's: `archs/<name>.py`.
"""
from __future__ import annotations

import functools

import torch

PEAK_BYTES = 3.35e12       # H100 SXM HBM3, bytes/s (data sheet)
# non-tensor float32; dense bf16; dense int8 (TOP/s), at the 700 W limit
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
SPLIT_TF32_FLOPS = 495e12 / 3   # float32 run as three TF32 products
EXPS_PER_CLOCK = 16 * 132       # exponential units: 16 a clock on 132 SMs
SM_CLOCK_MHZ = 1980             # the H100 SXM's maximum SM clock


# Kernel families of a device trace, matched in order on the lower-cased
# kernel name; the first family with a matching key takes the kernel. An
# architecture's own FAMILIES are tried before these for its cells.
FAMILIES = (("attention", ("flash", "fmha", "sdpa", "attention")),
            ("E int8 pack (ours)", ("pack_rows_kernel", "pack_nhwc_kernel",
                                    "pack_im2col_kernel")),
            ("E int8 GEMM (ours)", ("namespace)::gemm_kernel",)),
            ("transfer", ("memcpy", "memset")),
            ("convolution", ("fprop", "implicit", "conv", "cudnn", "winograd", "fft",
                             "dgrad", "wgrad")),
            ("matrix product", ("gemm", "cutlass", "cublas", "splitk", "nvjet")),
            ("softmax", ("softmax",)),
            ("reduction", ("reduce",)),
            ("copy / layout", ("copy", "cat", "transpose", "permute", "index",
                               "gather", "fill")),
            ("elementwise", ("elementwise", "vectorized", "unrolled")))


def family(kernel_name: str, table=FAMILIES) -> str:
    low = kernel_name.lower()
    for fam, keys in table:
        if any(k in low for k in keys):
            return fam
    return "other"


@functools.lru_cache(maxsize=None)
def _model_flops(reference, cfg_items: tuple, batch: int, h: int, w: int) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        model = reference(dict(cfg_items))
        a = torch.empty(batch, h, w, 3)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(a, a)
    return counter.get_total_flops()


def model_flops(reference, cfg: dict, batch: int, h: int, w: int) -> int:
    """Matrix-product and convolution FLOPs of one forward of the plain
    reference `reference(cfg)` (an architecture's `reference`) on a pair of
    (batch, h, w, 3) frames, counted by torch.utils.flop_counter on meta
    tensors."""
    return _model_flops(reference, tuple(sorted(cfg.items())), batch, h, w)
