"""S2M2 (arXiv:2507.13229) in the benchmark: all of the harness's work that
depends on the model, found by a configuration's `"architecture": "s2m2"`.

The program's entry is `StereoEngine.run(left, right)` on the S2M2 model,
which returns (disp, occ, conf, score, runtime_ms). The plain reference is
`portbench/reference/model.py`'s `S2M2`. A request is compared where the
reference's own matcher found a clear winner (`CLEAR`); the kernels the
attention roofline counts are A and B (`main_path_shapes`, `bound`).

The program under test is imported only inside `build_engine` and the
faults, so the reference side of a run loads nothing of it.
"""
from __future__ import annotations

import time
from collections import Counter
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from portbench import yardstick
from portbench.reference import model as ref

# ------------------------------------------------------------- the program

def build_engine(cell, device, precision=None):
    """The program's engine of the cell's configuration, on its normal path."""
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.runtime.engine import StereoEngine
    return StereoEngine(ModelConfig(**cell.model), precision=precision or cell.config["precision"],
                        device=device, fused_block=cell.config["fused_block"])


def unpack(out):
    """run's (disp, occ, conf, score, runtime_ms) as ({name: (B, H, W) map},
    score, runtime_ms); run gives (H, W) maps for a single pair."""
    disp, occ, conf, score, ms = out
    if disp.ndim == 2:
        disp, occ, conf = disp[None], occ[None], conf[None]
    return {"disp": disp, "occ": occ, "conf": conf}, score, ms


def sane(maps, score, shape) -> bool:
    """What every request is checked for in the window, at no cost to it:
    maps of the request's shape and a finite score in [0, 1] (the mean of
    the interior confidence, so a NaN there shows in it)."""
    return (all(m.shape == shape for m in maps.values())
            and np.isfinite(score) and 0.0 <= score <= 1.0)


# ----------------------------------------------------------- the reference

def reference(cfg: dict) -> torch.nn.Module:
    """The plain float32 S2M2 of `cfg`, on the current default device."""
    return ref.S2M2(cfg)


def layout(module: torch.nn.Module):
    """[(parameter name, shape, bound)] in state-dict order: each conv,
    transposed conv and linear weight and its bias uniform in
    +-1/sqrt(fan_in) (the reference initialisation's rule, after
    s2m2_torch/models/init.py); bound None for a norm's weight (1) and bias (0)."""
    bounds = {}
    for prefix, m in module.named_modules():
        if isinstance(m, (ref.Conv, ref.ConvT, ref.Linear)):
            b = m.fan_in() ** -0.5
            for name, _ in m.named_parameters(recurse=False):
                bounds[f"{prefix}.{name}"] = b
        elif isinstance(m, ref.Norm):
            bounds[f"{prefix}.weight"] = bounds[f"{prefix}.bias"] = None
    out = []
    for name, p in module.named_parameters():
        if name not in bounds:
            raise KeyError(f"no initialisation rule for parameter {name}")
        out.append((name, tuple(p.shape), bounds[name]))
    return out


# Frames whose sides are multiples of 32 need no padding and no crop, so a
# request is the forward on the float32 frames, its maps at input
# resolution, and the mean confidence over the interior MARGIN px in from
# each edge (the reference's self-calibration score, model_utils.py:93-94).
MARGIN = 100


def clear_match(matched, shape):
    """The matcher's confidence (B, 1, h, w) at 1/4 resolution, each pixel
    given the least of its 3x3 neighbourhood (the convex upsampling draws
    on that neighbourhood), repeated to the output's (H, W): (B, H, W)."""
    low = -F.max_pool2d(-matched, 3, stride=1, padding=1)
    s = shape[0] // low.shape[2]
    return low.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)[:, 0]


@torch.no_grad()
def reference_request(model, left, right, device):
    """(disp, occ, conf, score, match) of uint8 (B, H, W, 3) frames: float32
    (B, H, W) maps, one pair at a time on `device`, the score averaged over
    the request's pairs; `match` is `clear_match` of the matcher's confidence."""
    h, w = left.shape[1:3]
    if h % 32 or w % 32:
        raise ValueError(f"reference requests need sides that are multiples of 32, got {h}x{w}")
    maps = []
    for a, b in zip(left, right):
        ta, tb = (torch.from_numpy(np.asarray(x, np.float32))[None].to(device) for x in (a, b))
        *out, matched = model(ta, tb, match_conf=True)
        maps.append([o[0, ..., 0].cpu().numpy() for o in out]
                    + [clear_match(matched, out[0].shape[1:3])[0].cpu().numpy()])
    disp, occ, conf, match = (np.stack(m) for m in zip(*maps))
    inner = conf[:, MARGIN:-MARGIN, MARGIN:-MARGIN] if min(h, w) > 2 * MARGIN else conf
    return disp, occ, conf, float(inner.mean()), match


# ----------------------------------------------------------- the comparison

# The disparity is compared where the reference's own matcher found a clear
# winner. Elsewhere the model inpaints it from a hundred times a
# convolution's output and clamps it at 0, so on random weights the whole
# inpainted map moves with the last bits of that output, or sits at 0 for
# any precision on some seeds. A pixel is clear where the matcher put more
# than CLEAR of its transport mass within two columns of its best match, in
# all of the pixel's 3x3 neighbourhood at 1/4 resolution (the model keeps
# the matcher's disparity above 0.2 and inpaints below it).
CLEAR = 0.3


def pair_numbers(disp, occ, conf, rdisp, rocc, rconf, match) -> dict:
    """The gaps of one pair's maps from the reference's; `match` is the
    reference's `clear_match` map. With no clear pixel the disparity's
    number is NaN, which fails any limit."""
    d = np.abs(disp.astype(np.float64) - rdisp)
    clear = match > CLEAR
    return {
        "disp_clear_median_px": float(np.median(d[clear])) if clear.any() else float("nan"),
        "occ_median": float(np.median(np.abs(occ.astype(np.float64) - rocc))),
        "conf_median": float(np.median(np.abs(conf.astype(np.float64) - rconf))),
    }


def numbers(maps, reference_out) -> dict:
    """Each number, the worst over the request's pairs: `maps` as `unpack`
    gives them, `reference_out` as `reference_request` does."""
    rdisp, rocc, rconf, _, match = reference_out
    per_pair = [pair_numbers(maps["disp"][i], maps["occ"][i], maps["conf"][i],
                             rdisp[i], rocc[i], rconf[i], match[i])
                for i in range(len(maps["disp"]))]
    return {k: max(p[k] for p in per_pair) for k in per_pair[0]}


# ----------------------------------------------- faults and the control

def _refiner_unchanged():
    """The local refiner's step returns its state unchanged."""
    from s2m2_torch.models import refiners
    return mock.patch.object(
        refiners.LocalRefiner, "forward",
        lambda self, hidden, ctx, disp, conf, occ, cv: (hidden, disp.float(), conf.float(),
                                                        occ.float()))


def _disp_plus1():
    """The disparity one pixel off where the model produces it."""
    from s2m2_torch.models import s2m2
    forward = s2m2.S2M2.forward

    def altered(self, img0, img1, return_aux=False):
        disp, occ, conf = forward(self, img0, img1)
        return disp + 1.0, occ, conf

    return mock.patch.object(s2m2.S2M2, "forward", altered)


def _half_batch():
    """Half of a batch left out: the first half's maps served for all."""
    from s2m2_torch.runtime import engine
    forward = engine.StereoEngine.forward_padded

    def half(self, img0, img1):
        k = max(1, len(img0) // 2)
        outs = forward(self, img0[:k], img1[:k])
        return tuple(o.repeat(len(img0) // k, 1, 1, 1) for o in outs)

    return mock.patch.object(engine.StereoEngine, "forward_padded", half)


FAULTS = {"refiner_unchanged": _refiner_unchanged, "disp_plus1": _disp_plus1,
          "half_batch": _half_batch}


class ReferenceInPlace:
    """The reference behind `StereoEngine.run`'s interface, each conv and
    linear on TF32 operands: the precision below the float32 with TF32 off
    that the configurations state (the program has no TF32 path)."""

    def __init__(self, model, device):
        self.model, self.device = model, device
        for m in model.modules():
            if isinstance(m, ref._Gemm):
                m.tf32 = True

    def run(self, left, right):
        t = time.perf_counter()
        squeeze = left.ndim == 3
        if squeeze:
            left, right = left[None], right[None]
        disp, occ, conf, score, _ = reference_request(self.model, left, right, self.device)
        if squeeze:
            disp, occ, conf = disp[0], occ[0], conf[0]
        return disp, occ, conf, score, (time.perf_counter() - t) * 1e3


CONTROLS = {"ref_tf32": ReferenceInPlace}


# ------------------------------------------------ the own kernels' yardstick

ATTENTION = ("scanline_attention", "scanline_cross_attention")
SPLIT_TF32 = (*ATTENTION, "fused_basic_attn_block")   # A, B, D run float32 as three TF32 products


def main_path_shapes(cfg: dict, h: int, w: int) -> dict:
    """Per kernel, the Counter of input shapes one forward at (h, w) with
    batch 1 launches on the route with the fused block off: the MRT's
    scanline and 2D blocks, the pyramid's non-PE bottleneck blocks and the
    refiners' UNet bottlenecks (cross shapes per view), and the matcher.
    Copied from chip_smoke.py so that a change to the program cannot move it."""
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
    rate = yardstick.PEAK_FLOPS["int8" if name == "int8_attention" else dtype_name]
    if name in SPLIT_TF32 and dtype_name == "float32":
        rate = yardstick.SPLIT_TF32_FLOPS
    parts = (1e3 * nbytes / yardstick.PEAK_BYTES, 1e3 * flops / rate)
    if name == "fused_correlation_ot":
        parts += (1e3 * ot_exps(shape) / (yardstick.EXPS_PER_CLOCK
                                          * yardstick.SM_CLOCK_MHZ * 1e6),)
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


# The program's kernels of S2M2's own layers, tried before yardstick.FAMILIES.
FAMILIES = (("fused block (ours)", ("fused_block_kernel",)),
            ("correlation + Sinkhorn (ours)", ("corr_ot_kernel",)))
