"""The benchmark's fixed arithmetic: peaks of the card, the work of the
program's own kernels counted from their shapes, the kernel families of a
device trace, and the model's FLOPs counted over the plain reference.

Copied from chip_smoke.py (`PEAK_*`, `cost`, `bound`, `main_path_shapes`,
`FAMILIES`) so that a change to the program cannot move the yardstick.
"""
from __future__ import annotations

import functools
from collections import Counter

import torch

from .reference import model as ref

PEAK_BYTES = 3.35e12       # H100 SXM HBM3, bytes/s (data sheet)
# non-tensor float32; dense bf16; dense int8 (TOP/s), at the 700 W limit
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
SPLIT_TF32_FLOPS = 495e12 / 3   # A, B, D run float32 as three TF32 products
ATTENTION = ("scanline_attention", "scanline_cross_attention")
SPLIT_TF32 = (*ATTENTION, "fused_basic_attn_block")
EXPS_PER_CLOCK = 16 * 132       # exponential units: 16 a clock on 132 SMs
SM_CLOCK_MHZ = 1980             # the H100 SXM's maximum SM clock


def main_path_shapes(cfg: dict, h: int, w: int) -> dict:
    """Per kernel, the Counter of input shapes one forward at (h, w) with
    batch 1 launches on the route with the fused block off: the MRT's
    scanline and 2D blocks, the pyramid's non-PE bottleneck blocks and the
    refiners' UNet bottlenecks (cross shapes per view), and the matcher."""
    h4, w4, c = h // 4, w // 4, cfg["feature_channels"]
    nh, ntr = cfg["num_heads"], cfg["num_transformer"]
    tokens = (h4 // 8) * (w4 // 8)
    selfs, cross = Counter(), Counter()
    for hs, ws, ds, heads in ((h4, w4, c, nh), (h4 // 2, w4 // 2, c, 2 * nh),
                              (h4 // 4, w4 // 4, 2 * c, 4 * nh)):
        selfs[(2 * hs * heads, ws, ds // heads)] += 2 * ntr
        cross[(hs * heads, ws, ds // heads)] += 2 * ntr
    selfs[(2 * 8 * nh, tokens, 2 * c // (8 * nh))] += 4 * ntr
    cross[(8 * nh, tokens, 2 * c // (8 * nh))] += 4 * ntr
    selfs[(2 * 8, tokens, 2 * c // 8)] += 2 * ntr        # feat_pyramid dec3s
    selfs[(8, tokens, c // 8)] += 2                      # global refiner UNet
    selfs[(8, tokens, 2 * c // 8)] += 2 * cfg["refine_iter"]  # local refiner UNet
    return {"scanline_attention": selfs, "scanline_cross_attention": cross,
            "fused_correlation_ot": Counter({(1, h4, w4, c): 1})}


def ot_exps(shape, ot_iter=3, positivity=True):
    """Exponentials kernel C evaluates: the Sinkhorn sweeps over the
    (W+1)^2 dustbin-padded row (masked entries skipped under positivity)
    and the final probabilities."""
    b, h, w, _ = shape
    if positivity:
        sweep, final = w * (w + 1) // 2 + 2 * w + 1, w * (w + 1) // 2
    else:
        sweep, final = (w + 1) ** 2, w * w
    return b * h * (2 * ot_iter * sweep + final)


def cost(name, shape, dtype_name):
    """(bytes, flops) the function must move and do: each input read once,
    each output written once; the matrix products' flops."""
    isz = 4 if dtype_name == "float32" else 2
    if name == "fused_basic_attn_block":
        n, w, c, _ = shape
        e = c
        weights = (12 * c * e + 4 * e + 2 * c) * isz
        return 4 * n * w * c * isz + weights, 2 * n * w * 24 * c * e + n * 16 * w * w * e
    if name == "fused_correlation_ot":
        b, h, w, c = shape
        return (2 * b * h * w * c + 2 * b * h * w * w) * isz, 2 * b * h * w * w * c
    b, n, d = shape
    ndir = 2 if name == "scanline_cross_attention" else 1
    return ndir * 4 * b * n * d * isz, ndir * 4 * b * n * n * d


def bound(name, shape, dtype_name):
    """(bytes ms, operations ms[, exps ms]); the least time is the largest."""
    nbytes, flops = cost(name, shape, dtype_name)
    rate = PEAK_FLOPS["int8" if name == "int8_attention" else dtype_name]
    if name in SPLIT_TF32 and dtype_name == "float32":
        rate = SPLIT_TF32_FLOPS
    parts = (1e3 * nbytes / PEAK_BYTES, 1e3 * flops / rate)
    if name == "fused_correlation_ot":
        parts += (1e3 * ot_exps(shape) / (EXPS_PER_CLOCK * SM_CLOCK_MHZ * 1e6),)
    return parts


def attention_bound_ms(cfg: dict, h: int, w: int, batch: int, dtype_name: str) -> float:
    """The least device ms of one call's A and B launches (kernel A and B
    calls of `main_path_shapes`, each shape's batch axis times `batch`)."""
    shapes = main_path_shapes(cfg, h, w)
    total = 0.0
    for name in ATTENTION:
        for (b, n, d), count in shapes[name].items():
            total += count * max(bound(name, (b * batch, n, d), dtype_name))
    return total


# Kernel families of a device trace, matched in order on the lower-cased
# kernel name; the first family with a matching key takes the kernel.
FAMILIES = (("fused block (ours)", ("fused_block_kernel",)),
            ("attention", ("scanline_attention_kernel", "flash", "fmha", "sdpa",
                           "attention")),
            ("correlation + Sinkhorn (ours)", ("corr_ot_kernel",)),
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


def family(kernel_name: str) -> str:
    low = kernel_name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


@functools.lru_cache(maxsize=None)
def _model_flops(cfg_items: tuple, batch: int, h: int, w: int) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        model = ref.S2M2(dict(cfg_items))
        a = torch.empty(batch, h, w, 3)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(a, a)
    return counter.get_total_flops()


def model_flops(cfg: dict, batch: int, h: int, w: int) -> int:
    """Matrix-product and convolution FLOPs of one forward of the plain
    reference at (batch, h, w), counted by torch.utils.flop_counter on meta
    tensors."""
    return _model_flops(tuple(sorted(cfg.items())), batch, h, w)
