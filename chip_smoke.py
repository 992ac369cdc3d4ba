#!/usr/bin/env python3
"""Smoke run of the s2m2_torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Run from the root of a checkout, on a machine with a CUDA card, `nvcc` and
PyTorch built for CUDA. It imports nothing of JAX or of `s2m2_tpu`. Phases,
each printing one JSON line; any failure raises and the script exits
non-zero:

1. device: the card's name, power limit and maximum SM clock (nvidia-smi)
   and the versions;
2. build: compiles `s2m2_torch/csrc/*.cu` (one nvcc each, in parallel) into
   `build/s2m2_torch/`;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, in float32 and bfloat16 (B through the packed wrapper the model
   calls), with times (CUDA events, median of 20; for A, B and C each
   sample spans 10 back-to-back calls, and `ms_single` /
   `library_ms_single` keep the one-call times) of the kernel, the plain
   version and, for attention,
   F.scaled_dot_product_attention as a yardstick the port never calls: A, B
   and C at the shapes one S 1216x1024 forward gives them, A, B and C also
   at every shape of an XL 1216x1024 forward with the fused block off (each
   A/B record names the kernel instance that ran, each C record the
   `ops.sinkhorn.plan` route; C's bound adds its exponentials at the SMs'
   16 a clock and maximum clock to bytes and flops); D (the fused
   BasicAttnBlock) at the shapes one XL 1216x1024 forward with the fused
   route gives it, plus S's and L's widest, with seeded block weights from
   the port's own init, each record naming the instance
   `ops.fused_block.plan` chose, and, beside it, the port's unfused block on
   the same rows (float32 bounds of A, B and D by split TF32);
4. golden: the port on the card, kernels engaged, float32 with TF32 off, on
   every tests/golden/s2m2_*.npz against the reference outputs, with the
   fused block off and then on (kernel D engaged);
5. main path: StereoEngine("S") in fp32 and bf16 with seeded random weights
   serving 8 requests each on 1216x1024 pairs (the right image is the left
   shifted by a known disparity, plus noise); the kernels' launch counts are
   read around these requests only; then one more forward per precision
   under torch.profiler gives the device time by kernel family;
6. XL path: StereoEngine("XL") at 1216x1024 on the first 4 pairs of phase
   5, in bf16 with the fused block on, bf16 with it off on the same
   weights, and fp32 with it on; each run's launch counts must equal the
   counts worked out from XL's shapes, and one profiled forward follows it;
   the fused and unfused bf16 disparities are compared;
7. int8 path: StereoEngine("XL", precision="int8") at 1216x1024 with the
   same seeded weights: calibrate on the first pair (decimated to 512 px,
   as run() does), then 4 requests on phase 5's pairs, then one profiled
   forward; then S in int8a and int8r, 2 requests each. Each run checks A,
   B and C against the counts of phase 5/6, D at 0 (the fused route is
   off), every quantized GEMM of the calibration pass served by kernel E,
   and E's launches against the forward's own record of its sites;
8. calibration path: online self-calibration as a user runs it, with no
   OpenCV: StereoEngine("S", precision="bf16") on phase 5's first pair as a
   raw uint8 pair under a synthetic 1216x1024 sensor calibration (5
   distortion coefficients a camera, principal points apart, a 120 mm
   baseline and a stereo rotation of a few mrad). First the native host
   library (built in phase 2 with g++) against its numpy versions: the
   remap of both images with the port's numpy maps within 1 grey level,
   the blurred pad of a 1200x1000 frame within 1e-3. Then
   `cem_calibration` at its defaults (seed 0) and
   `gradient_descent_calibration` with one iteration, each with its
   candidates, the median host ms per candidate to build the maps and to
   remap, the median ms of the engine call, the wall seconds and the
   initial and final confidence; no candidate may score 0.0 (with a valid
   calibration that would be a swallowed error) and A, B and C must have
   launched the S bf16 forward's counts once per candidate. Then
   run(n_repeat=4) against run(n_repeat=1) on the rectified pair, one line
   of `python -m s2m2_torch.tools.bench --model S --precision bf16 --iters
   5`, and a check that cv2 was never imported.

Kernel E (int8 quantize_pack + the wgmma int8 GEMM) is held against its
plain version in phase 3 at the TPU probe's shape, and after phase 7 at
every site shape one XL int8 forward gives it, in row mode and in conv
mode (implicit GEMM on the NHWC int8 tensor), timed by the device (10
back-to-back calls) and by one call, beside torch._int_mm (which the port
never calls) as the yardstick of its GEMM and the bound of each site's own
work; phase 7 also fails if a conv with C >= 32 packed explicit im2col
rows. Phase 4 also runs the golden fixtures under int8 and int8r. Then it prints the kernels line, the
nvidia-smi line, and as its last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
H, W = 1024, 1216          # the main path's image size
N_REQUESTS = 8
N_XL_REQUESTS = 4
PEAK_BYTES = 3.35e12       # H100 SXM HBM3, bytes/s
# non-tensor fp32; dense bf16; dense int8 (TOP/s)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
# kernels A, B and D run float32 as split TF32: three TF32 products (495
# TFLOP/s dense) per float32 product, so a third of the TF32 rate
SPLIT_TF32_FLOPS = 495e12 / 3
ATTENTION = ("scanline_attention", "scanline_cross_attention")
# kernel C's float32 correlation is sequential FFMA (the plain version's
# sum, which split TF32 cannot match at C = 384), so it is not in SPLIT_TF32
SPLIT_TF32 = (*ATTENTION, "fused_basic_attn_block")
# kernels timed over 10 back-to-back calls (one call kept as ms_single) and
# also at every shape of an XL forward with the fused block off
XL_TIMED = (*ATTENTION, "fused_correlation_ot")
# the exponential units: 16 results a clock on each of the H100's 132 SMs,
# at the SM clock nvidia-smi reports as its maximum (phase 1 reads it)
EXPS_PER_CLOCK = 16 * 132
SM_CLOCK_MHZ = None
OT_ITER = 3  # Sinkhorn iterations of the model's matcher (and of phase 3's calls)
REPLACES = {
    "scanline_attention": "s2m2_tpu/ops/flash_attention.py:58",
    "scanline_cross_attention": "s2m2_tpu/ops/flash_attention.py:101",
    "fused_correlation_ot": "s2m2_tpu/ops/sinkhorn.py:82",
    "fused_basic_attn_block": "s2m2_tpu/ops/fused_block.py:174",
    "int8_quantize_pack": "scripts/probe_pallas_int8.py:30",
    "int8_gemm": "scripts/probe_pallas_int8.py:45",
}
SOURCES = {
    "scanline_attention": "s2m2_torch/csrc/scanline_attention.cu",
    "scanline_cross_attention": "s2m2_torch/csrc/scanline_attention.cu",
    "fused_correlation_ot": "s2m2_torch/csrc/sinkhorn_ot.cu",
    "fused_basic_attn_block": "s2m2_torch/csrc/fused_basic_attn_block.cu",
    "int8_quantize_pack": "s2m2_torch/csrc/int8_gemm.cu",
    "int8_gemm": "s2m2_torch/csrc/int8_gemm.cu",
}
N_INT8_S_REQUESTS = 2
# the JAX package's int8 drift bounds (tests/test_quant.py:186-191)
GOLDEN_INT8 = (("s2m2_c32_ntr1.npz", "int8", 0.01), ("s2m2_c32_ntr1_neg_up.npz", "int8", 0.08),
               ("s2m2_c32_ntr1.npz", "int8r", 0.015),
               ("s2m2_c32_ntr1_neg_up.npz", "int8r", 0.09))
OUT_DIR = None  # --out DIR: also keep the run's records there
# launches per XL 1216x1024 forward, by route of the scanline blocks: D
# takes the 1x and 2x blocks (C = 384); the 1/16-scale blocks (C = 768) and
# the 2D blocks stay on A and B; C is the matcher
XL_LAUNCHES = {
    True: {"fused_basic_attn_block": 12, "scanline_attention": 32,
           "scanline_cross_attention": 18, "fused_correlation_ot": 1},
    False: {"fused_basic_attn_block": 0, "scanline_attention": 44,
            "scanline_cross_attention": 30, "fused_correlation_ot": 1},
}


def emit(obj):
    """One JSON line on stdout and, with --out DIR, in DIR/chip_smoke.jsonl."""
    line = json.dumps(obj)
    print(line, flush=True)
    if OUT_DIR is not None:
        with open(OUT_DIR / "chip_smoke.jsonl", "a") as f:
            f.write(line + "\n")


def main_path_shapes(cfg, h, w, fused_block=False):
    """Per kernel, the Counter of input shapes one forward at (h, w) launches
    (batch 1): the MRT's scanline and 2D blocks, the pyramid's non-PE
    bottleneck blocks and the refiners' UNet bottlenecks; cross shapes are
    per view. With `fused_block`, the scanline blocks with C, E <= 512 go to
    D, as (row pairs, W, C, heads), instead of A and B."""
    from s2m2_torch.ops.fused_block import supports
    h4, w4, c, nh, ntr = h // 4, w // 4, cfg.feature_channels, cfg.num_heads, \
        cfg.num_transformer
    tokens = (h4 // 8) * (w4 // 8)
    selfs, cross, blocks = Counter(), Counter(), Counter()
    for hs, ws, ds, heads in ((h4, w4, c, nh), (h4 // 2, w4 // 2, c, 2 * nh),
                              (h4 // 4, w4 // 4, 2 * c, 4 * nh)):
        if fused_block and supports(ds, cfg.dim_expansion * ds):
            blocks[(hs, ws, ds, heads)] += 2 * ntr
            continue
        selfs[(2 * hs * heads, ws, ds // heads)] += 2 * ntr
        cross[(hs * heads, ws, ds // heads)] += 2 * ntr
    selfs[(2 * 8 * nh, tokens, 2 * c // (8 * nh))] += 4 * ntr
    cross[(8 * nh, tokens, 2 * c // (8 * nh))] += 4 * ntr
    selfs[(2 * 8, tokens, 2 * c // 8)] += 2 * ntr        # feat_pyramid dec3s
    selfs[(8, tokens, c // 8)] += 2                      # global refiner UNet
    selfs[(8, tokens, 2 * c // 8)] += 2 * cfg.refine_iter  # local refiner UNet
    return {"scanline_attention": selfs, "scanline_cross_attention": cross,
            "fused_correlation_ot": Counter({(1, h4, w4, c): 1}),
            "fused_basic_attn_block": blocks}


def time_ms(fn, n=20, warmup=3, reps=1):
    """Median over n CUDA-event timings of `reps` back-to-back calls, per
    call, after warmup calls. With reps = 1 the time includes the call's
    host dispatch whenever that is longer than the work queued before it."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def ot_exps(shape, positivity=True, ot_iter=OT_ITER):
    """Exponentials kernel C's function needs: 2 ot_iter log-sum-exp sweeps
    over the entries of the (W+1)^2 row that are not masked (j <= i, the
    dustbin row and column; all of them without positivity) and the final
    pass over the unmasked W x W entries, for every row."""
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
        # rows in and out of both views plus the 18 weights (E = C); the 12
        # C x E products of every token and, per row pair, 4 attentions of
        # Q K^T and P V
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
    """(bytes ms, operations ms[, exps ms]): the bytes over the memory rate,
    the flops over the peak rate for the dtype (split TF32's for A, B and D
    in float32) and, for kernel C, its exponentials over the SMs'
    exponential rate at their maximum clock; the bound is the largest."""
    nbytes, flops = cost(name, shape, dtype_name)
    rate = PEAK_FLOPS[dtype_name]
    if name in SPLIT_TF32 and dtype_name == "float32":
        rate = SPLIT_TF32_FLOPS
    parts = (1e3 * nbytes / PEAK_BYTES, 1e3 * flops / rate)
    if name == "fused_correlation_ot":
        parts += (1e3 * ot_exps(shape) / (EXPS_PER_CLOCK * SM_CLOCK_MHZ * 1e6),)
    return parts


def phase_device():
    import torch
    global SM_CLOCK_MHZ
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[torch.cuda.current_device()]
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    SM_CLOCK_MHZ = float(clock.splitlines()[torch.cuda.current_device()])
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "sm_clock_max_mhz": SM_CLOCK_MHZ})
    return smi


def phase_build():
    """Build every kernel; fail if an instance of A/B spills registers."""
    import re
    from s2m2_torch import native
    from s2m2_torch.ops import _build
    native_seconds = native.build()  # the host library (g++), before nvcc starts
    seconds = _build.build_all()
    ptxas = {}
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        ptxas[log.stem] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
    spills = [ln for ln in ptxas.get("scanline_attention", [])
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
    # kernel E's GEMM: spills, and the compiler's notes on wgmma and setmaxnreg
    gemm_notes = [ln.strip()[:160] for ln in
                  (_build.BUILD_DIR / "int8_gemm.log").read_text().splitlines()
                  if re.search(r"[1-9]\d* bytes spill|C7519|C7508|C7510|wgmma|setmaxnreg", ln)]
    emit({"phase": "build", "seconds": seconds, "native_seconds": native_seconds,
          "ptxas": ptxas,
          "scanline_attention_spill_lines": spills, "int8_gemm_notes": gemm_notes[:40],
          "int8_gemm_note_count": len(gemm_notes)})
    if spills:
        raise AssertionError(f"scanline_attention instances spill: {spills}")
    return native_seconds


def _max_err_ok(got, ref, dtype_name, kind):
    """(max|diff|, bound description, ok) for one output."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    err = float(diff.max())
    if dtype_name == "bfloat16":
        limit = 2e-2 * float(ref.abs().max())
        return err, f"<= 2e-2*max|ref| = {limit:.3e}", err <= limit
    if kind == "block":
        limit = 1e-4 * max(1.0, float(ref.abs().max()))
        return err, f"<= 1e-4*max(1, max|ref|) = {limit:.3e}", err <= limit
    if kind == "prob":
        excess = float((diff - (1e-6 + 1e-4 * ref.abs())).max())
        return err, "<= 1e-6 + 1e-4*|ref|", excess <= 0
    limit = 1e-3 if kind == "cv" else 1e-4
    return err, f"<= {limit:g}", err <= limit


def seeded_block(c, heads, seed=0):
    """A BasicAttnBlock of width c with the port's seeded init weights."""
    from s2m2_torch.models.attention import BasicAttnBlock
    from s2m2_torch.models.init import _basic_attn_block, _Rng
    from s2m2_torch.tools.convert import flatten, from_jax
    blk = BasicAttnBlock(c, heads)
    blk.load_state_dict(from_jax(flatten(_basic_attn_block(_Rng(seed), c, heads, 1))))
    return blk


def packed_cross_plain(q, k, v):
    """Kernel B's plain version on the packed (x | y) batch: (2B, N, D) in,
    attn(qx, ky, vy) then attn(qy, kx, vx) out."""
    import torch
    from s2m2_torch.ops import flash_attention as fa
    h = q.shape[0] // 2
    return torch.cat(fa.scanline_cross_attention_plain(q[:h], k[:h], v[:h], q[h:], k[h:], v[h:]))


def phase_kernels(shapes, xl_shapes):
    """`shapes`: per kernel, the Counter of shapes (and launches per forward)
    of the S forward (D's: of the XL fused forward); `xl_shapes`: A's, B's
    and C's of the XL unfused forward, timed as well and tagged "XL"."""
    import torch
    import torch.nn.functional as F
    from s2m2_torch.models.layers import layer_norm
    from s2m2_torch.ops import flash_attention as fa
    from s2m2_torch.ops import fused_block as fb
    from s2m2_torch.ops import sinkhorn

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    results = {name: {"float32": [], "bfloat16": []} for name in shapes}
    # D: S's 1x scale and L's widest scanline block, not on the XL path
    extra = {"fused_basic_attn_block": [(256, 304, 128, 1), (64, 76, 512, 4)]}
    failures = []
    for name, counter in shapes.items():
        todo = [(s, n, "S") for s, n in counter.items()] + \
            [(s, 0, "S") for s in extra.get(name, [])] + \
            [(s, n, "XL") for s, n in xl_shapes.get(name, {}).items()]
        if name == "fused_basic_attn_block":
            todo = [(s, n, "XL" if n else "S/L") for s, n, _ in todo]
        for shape, per_forward, model in todo:
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[1]
                unfused = instance = None
                if name == "fused_basic_attn_block":
                    n, w, c, heads = shape
                    blk = seeded_block(c, heads).to(dev, dtype)
                    wts = blk.fused_weights()
                    rows = torch.randn((2 * n, w, c), generator=g, device=dev).to(dtype)
                    got = fb.fused_basic_attn_block(rows, n, wts, heads)
                    ref = torch.cat(fb.fused_basic_attn_block_plain(rows[:n], rows[n:], wts,
                                                                    heads))
                    checks = [("block", got, ref)]
                    kern = lambda: fb.fused_basic_attn_block(rows, n, wts, heads)  # noqa: E731
                    plain = lambda: fb.fused_basic_attn_block_plain(  # noqa: E731
                        rows[:n], rows[n:], wts, heads)
                    unfused = lambda: blk.forward_rows(rows)  # noqa: E731  (blk.fused is off)
                    lib = None
                    instance = fb.plan(w, c, c, heads, dtype)._asdict()
                elif name == "fused_correlation_ot":
                    f0, f1 = (layer_norm(torch.randn(shape, generator=g, device=dev))
                              .to(dtype) for _ in range(2))
                    got = sinkhorn.fused_correlation_ot(f0, f1)
                    ref = sinkhorn.fused_correlation_ot_plain(f0, f1)
                    checks = [("prob", got[0], ref[0]), ("cv", got[1], ref[1])]
                    kern = lambda: sinkhorn.fused_correlation_ot(f0, f1)  # noqa: E731
                    plain = lambda: sinkhorn.fused_correlation_ot_plain(f0, f1)  # noqa: E731
                    lib = None
                    instance = sinkhorn.plan(shape[2], shape[3], dtype, True)._asdict()
                else:
                    # B as the model calls it: the packed (x | y) batch, (2B, N, D)
                    b = shape[0]
                    if name == "scanline_cross_attention":
                        b *= 2
                        fn, plain_fn = fa.scanline_cross_attention_packed, packed_cross_plain
                    else:
                        fn, plain_fn = fa.scanline_attention, fa.scanline_attention_plain
                    xs = [torch.randn((b, *shape[1:]), generator=g, device=dev).to(dtype)
                          for _ in range(3)]
                    got, ref = fn(*xs), plain_fn(*xs)
                    checks = [("attn", got, ref)]
                    kern = lambda: fn(*xs)  # noqa: E731
                    plain = lambda: plain_fn(*xs)  # noqa: E731
                    instance = fa.plan(dtype, shape[-1])._asdict()
                    # (B, 1, N, D) views: SDPA's fused backends take 4D inputs
                    q4, k4, v4 = (x.unsqueeze(1) for x in xs)
                    if name == "scanline_attention":
                        lib = lambda: F.scaled_dot_product_attention(q4, k4, v4)  # noqa: E731
                    else:
                        h = b // 2
                        lib = lambda: (  # noqa: E731
                            F.scaled_dot_product_attention(q4[:h], k4[h:], v4[h:]),
                            F.scaled_dot_product_attention(q4[h:], k4[:h], v4[:h]))
                torch.cuda.synchronize()
                errs = []
                for kind, a, b in checks:
                    err, limit, ok = _max_err_ok(a, b, dn, kind)
                    errs.append({"output": kind, "max_abs_err": err, "bound": limit,
                                 "ok": ok})
                    if not ok:
                        failures.append((name, shape, dn, kind, err, limit))
                reps = 10 if name in XL_TIMED else 1
                rec = {"kernel": name, "model": model, "shape": list(shape), "dtype": dn,
                       "per_forward": per_forward, "checks": errs,
                       "ms": time_ms(kern, reps=reps), "plain_ms": time_ms(plain, reps=reps),
                       "library_ms": time_ms(lib, reps=reps) if lib else None,
                       "bound_ms": max(bound(name, shape, dn)),
                       "bound_parts_ms": bound(name, shape, dn)}
                if unfused is not None:  # the port's unfused block, A/B and cuBLAS
                    rec["unfused_ms"] = time_ms(unfused)
                if instance is not None and name in ATTENTION:
                    rec.update(instance=instance, ms_single=time_ms(kern),
                               library_ms_single=time_ms(lib))
                elif name == "fused_correlation_ot":  # C: its plan, one call
                    rec.update(plan=instance, ms_single=time_ms(kern))
                elif instance is not None:  # D: the plan's instance
                    rec["instance"] = instance
                emit({"phase": "kernels", **rec})
                results[name][dn].append(rec)
    if failures:
        raise AssertionError(f"kernel/plain disagreement: {failures}")
    return results


def golden_fixture(path):
    """(cfg, NHWC img0, img1, [disp, occ, conf] references) of a fixture."""
    from s2m2_torch.config import ModelConfig
    with np.load(path) as z:
        meta = list(z["__meta"])
        img0 = np.transpose(z["__img0"], (0, 2, 3, 1))
        img1 = np.transpose(z["__img1"], (0, 2, 3, 1))
        refs = [np.transpose(z[k], (0, 2, 3, 1)) for k in ("__disp", "__occ", "__conf")]
    cfg = ModelConfig(feature_channels=int(meta[0]), num_transformer=int(meta[1]),
                      refine_iter=int(meta[2]),
                      use_positivity=bool(meta[3]) if len(meta) > 3 else True,
                      output_upsample=bool(meta[4]) if len(meta) > 4 else False)
    return cfg, img0, img1, refs


def phase_golden_int8():
    """The golden fixtures in int8 and int8r engines on the card (bf16 with
    the fp32 islands, calibrated on the fixture's pair, kernel E engaged):
    EPE against the fp32 reference within the JAX package's bounds."""
    from s2m2_torch.ops import _build
    from s2m2_torch.runtime.engine import StereoEngine
    for fixture, precision, bound in GOLDEN_INT8:
        path = ROOT / "tests" / "golden" / fixture
        cfg, img0, img1, refs = golden_fixture(path)
        eng = StereoEngine(cfg, checkpoint=str(path), precision=precision, device="cuda")
        eng.calibrate(img0, img1)
        _build.reset_launch_counts()
        disp = eng.forward_padded(img0, img1)[0].cpu().numpy()
        counts = {k: _build.launch_counts[k] for k in ("int8_quantize_pack", "int8_gemm")}
        epe = float(np.abs(disp - refs[0]).mean())
        ok = bool(epe < bound and min(counts.values()) > 0 and np.isfinite(disp).all())
        emit({"phase": "golden_int8", "fixture": fixture, "precision": precision,
              "epe": epe, "bound": bound, "sites": len(eng.quant_scales),
              "launches": counts, "ok": ok})
        if not ok:
            raise AssertionError(f"golden {precision} failed on {fixture}: EPE {epe}, "
                                 f"launches {counts}")


def phase_golden(fused_block):
    import torch
    from s2m2_torch.models.s2m2 import S2M2
    from s2m2_torch.ops import _build
    from s2m2_torch.ops.fused_block import supports
    from s2m2_torch.tools.convert import load_npz

    paths = sorted(glob.glob(str(ROOT / "tests" / "golden" / "s2m2_*.npz")))
    if not paths:
        raise FileNotFoundError("no tests/golden/s2m2_*.npz fixtures")
    for path in paths:
        cfg, img0, img1, refs = golden_fixture(path)
        model = S2M2(cfg, fused_block=fused_block)
        model.load_state_dict(load_npz(path))
        model = model.cuda().eval()
        _build.reset_launch_counts()
        with torch.inference_mode():
            outs = model(torch.from_numpy(img0).cuda(), torch.from_numpy(img1).cuda())
        blocks = _build.launch_counts["fused_basic_attn_block"]
        want = 0
        if fused_block:  # two scanline blocks per scale and MRT, where C, E <= 512
            want = 2 * cfg.num_transformer * sum(
                supports(d, cfg.dim_expansion * d) for d in cfg.unet_dims)
        if blocks != want:
            raise AssertionError(f"{path}: fused block launched {blocks} times, "
                                 f"expected {want}")
        d, o, c = (t.float().cpu().numpy() for t in outs)
        errs = {"disp": float(np.abs(d - refs[0]).max()),
                "occ": float(np.abs(o - refs[1]).max()),
                "conf": float(np.abs(c - refs[2]).max()),
                "epe": float(np.abs(d - refs[0]).mean())}
        ok = (errs["disp"] <= 2e-2 and errs["occ"] <= 2e-3 and errs["conf"] <= 2e-3
              and errs["epe"] < 1e-3)
        emit({"phase": "golden", "fixture": os.path.basename(path), "fused_block": fused_block,
              "fused_block_launches": blocks, **errs,
              "bounds": {"disp": 2e-2, "occ": 2e-3, "conf": 2e-3, "epe": 1e-3}, "ok": ok})
        if not ok:
            raise AssertionError(f"golden parity failed on {path}: {errs}")


def _stereo_pair(rng, h, w, disp):
    """A smooth random texture and its copy shifted left by `disp` pixels
    (left pixel x matches right pixel x - disp), plus noise, in [0, 255]."""
    base = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1, 3)).astype(np.float32)
    left = np.repeat(np.repeat(base, 8, 0), 8, 1)[:h, :w]
    left = left + rng.normal(0, 8, left.shape).astype(np.float32)
    right = np.roll(left, -disp, axis=1) + rng.normal(0, 2, left.shape).astype(np.float32)
    return np.clip(left, 0, 255), np.clip(right, 0, 255)


FAMILIES = (("fused block (ours)", ("fused_block_kernel",)),
            ("ours: scanline attention", ("scanline_attention_kernel",)),
            ("ours: correlation + Sinkhorn", ("corr_ot_kernel",)),
            ("ours: E int8 pack", ("pack_rows_kernel", "pack_nhwc_kernel",
                                   "pack_im2col_kernel")),
            ("ours: E int8 GEMM", ("namespace)::gemm_kernel",)),
            ("convolution (cuDNN)", ("fprop", "implicit", "conv", "cudnn", "winograd",
                                     "fft")),
            ("matrix product (cuBLAS)", ("gemm", "cutlass", "cublas", "splitk", "nvjet")),
            ("softmax", ("softmax",)),
            ("reduction", ("reduce",)),
            ("copy / layout", ("copy", "cat", "transpose", "permute", "index",
                               "gather", "fill")),
            ("elementwise", ("elementwise", "vectorized", "unrolled")))


def _family(name):
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def profile_forward(eng, precision, left, right):
    """Device time by kernel family over one traced forward (torch.profiler,
    CUDA activity), beside the forward's host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    a, b = left[None], right[None]
    eng.forward_padded(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.forward_padded(a, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = Counter()
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] += evt.self_device_time_total / 1e3
    busy = sum(kernels.values())
    fams = Counter()
    for name, ms in kernels.items():
        fams[_family(name)] += ms
    return {"phase": "profile", "precision": precision, "wall_ms": wall_ms,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "idle_share": 1 - busy / wall_ms if busy > 0 else "not measured",
            "families_ms": dict(fams.most_common()),
            "top_kernels_ms": [(k[:90], v) for k, v in kernels.most_common(12)]}


def serve(eng, label, pairs, per_forward):
    """Run `pairs` through eng.run with the launch counts set to 0 just
    before and read just after; check the outputs and the counts against
    per_forward x requests. Returns (ms per request, disparities, counts,
    peak device memory)."""
    import torch
    from s2m2_torch.ops import _build
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    ms, disps = [], []
    for left, right in pairs:
        disp, occ, conf, score, t = eng.run(left, right)
        for name, arr in (("disp", disp), ("occ", occ), ("conf", conf)):
            if arr.shape != (H, W) or not np.isfinite(arr).all():
                raise AssertionError(f"{label}: {name} not finite (H, W)")
        if disp.min() < 0 or occ.min() < 0 or occ.max() > 1 or conf.min() < 0 \
                or conf.max() > 1:
            raise AssertionError(f"{label}: outputs out of range")
        ms.append(t)
        disps.append(disp)
    counts = dict(_build.launch_counts)
    for name, n in per_forward.items():
        if counts[name] != n * len(pairs):
            raise AssertionError(f"{label}: {name} launched {counts[name]} "
                                 f"times, expected {n} x {len(pairs)}")
    return ms, disps, counts, torch.cuda.max_memory_allocated()


def phase_main_path(shapes, pairs):
    import torch
    from s2m2_torch.runtime.engine import StereoEngine

    per_forward = {k: sum(v.values()) for k, v in shapes.items()}
    launches = Counter()
    for precision in ("fp32", "bf16"):
        eng = StereoEngine("S", precision=precision, seed=0)
        ms, _, counts, peak = serve(eng, f"S {precision}", pairs, per_forward)
        launches.update(counts)
        med = float(np.median(ms))
        emit(profile_forward(eng, precision, *pairs[0]))
        emit({"phase": "main_path", "model": "S", "precision": precision,
              "height": H, "width": W, "requests": len(pairs), "ms_per_frame": ms,
              "median_ms": med, "fps": 1e3 / med, "max_memory_allocated": peak,
              "launches": counts,
              "benchmark": eng.benchmark(H, W, n_warmup=1, n_iter=5)})
        del eng
        torch.cuda.empty_cache()
    return launches


def phase_xl(pairs):
    """XL at 1216x1024: bf16 fused, bf16 unfused on the same weights, fp32
    fused; returns the launches of the three runs together."""
    import torch
    from s2m2_torch.config import get_config
    from s2m2_torch.runtime.engine import StereoEngine

    cfg = get_config("XL")
    launches = Counter()
    disps = {}

    def run(eng, precision, fused):
        eng.model.set_fused_block(fused)
        per_forward = {k: sum(v.values())
                       for k, v in main_path_shapes(cfg, H, W, fused).items()}
        if per_forward != XL_LAUNCHES[fused]:
            raise AssertionError(f"XL launches from its shapes {per_forward} differ from "
                                 f"{XL_LAUNCHES[fused]}")
        label = f"XL {precision} fused_block={fused}"
        ms, disps[(precision, fused)], counts, peak = serve(eng, label, pairs, per_forward)
        launches.update(counts)
        med = float(np.median(ms))
        emit({**profile_forward(eng, precision, *pairs[0]), "model": "XL",
              "fused_block": fused})
        emit({"phase": "xl_path", "model": "XL", "precision": precision,
              "fused_block": fused, "height": H, "width": W, "requests": len(pairs),
              "ms_per_frame": ms, "median_ms": med, "fps": 1e3 / med,
              "max_memory_allocated": peak, "launches": counts,
              "launches_per_forward": per_forward})

    eng = StereoEngine("XL", precision="bf16", seed=0, fused_block=True)
    run(eng, "bf16", True)
    run(eng, "bf16", False)
    del eng
    torch.cuda.empty_cache()
    run(StereoEngine("XL", precision="fp32", seed=0, fused_block=True), "fp32", True)
    torch.cuda.empty_cache()
    delta = [float(np.abs(a - b).mean())
             for a, b in zip(disps[("bf16", True)], disps[("bf16", False)])]
    emit({"phase": "xl_fused_vs_unfused", "precision": "bf16",
          "mean_abs_disp_diff_px": float(np.mean(delta)), "per_request": delta})
    return launches, disps[("bf16", False)]


def phase_probe():
    """Kernel E as the TPU probe runs it (scripts/probe_pallas_int8.py): 8
    chained (8, 304, 384) @ (384, 384) products, int8 and bf16, against the
    plain chain. int8 must be bit-equal; bf16 within 2e-2 * max|ref|."""
    import torch
    from s2m2_torch.ops import int8_gemm as ig
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((8, 304, 384), generator=g, device="cuda") * 0.1).bfloat16()
    out = {}
    for kind in ("int8", "bf16"):
        if kind == "int8":
            w = torch.randint(-127, 128, (384, 384), generator=g, device="cuda",
                              dtype=torch.int8)
        else:
            w = (torch.randn((384, 384), generator=g, device="cuda") * 0.05).bfloat16()
        got, ref = ig.probe_chain(x, w, kind), ig.probe_chain_plain(x, w, kind)
        err = float((got.float() - ref.float()).abs().max())
        ok = err == 0 if kind == "int8" else err <= 2e-2 * float(ref.float().abs().max())
        ops = 2 * ig.PROBE_REPS * 8 * 304 * 384 * 384
        nbytes = 2 * x.numel() * 2 + w.numel() * w.element_size()
        rec = {"phase": "kernels", "kernel": "probe_chain", "kind": kind,
               "shape": [8, 304, 384], "max_abs_err": err, "ok": ok,
               "ms": time_ms(lambda: ig.probe_chain(x, w, kind)),  # noqa: B023
               "plain_ms": time_ms(lambda: ig.probe_chain_plain(x, w, kind)),  # noqa: B023
               "bound_ms": 1e3 * max(nbytes / PEAK_BYTES,
                                     ops / PEAK_FLOPS["int8" if kind == "int8"
                                                      else "bfloat16"])}
        emit(rec)
        if not ok:
            raise AssertionError(f"probe_chain {kind}: max|diff| {err}")
        out[kind] = rec
    return out


def _int8_counts(eng, label, counts, n_requests):
    """Check one served int8 run: every quantized GEMM that the calibration
    pass saw ran in each forward, and E's launches match the forward's own
    record of its packs and GEMMs, and no conv with C >= 32 packed explicit
    im2col rows. Returns (E's launches per forward, the forward's site
    log)."""
    from s2m2_torch.models import quant
    from s2m2_torch.ops import int8_gemm as ig
    log = quant.last_log()
    sites = sum(r["kind"] == "gemm_site" for r in log)
    per = {"int8_quantize_pack": sum(r["kind"] == "pack" for r in log),
           "int8_gemm": sum(r["kind"] == "gemm" for r in log)}
    if sites != eng.quant_gemms or min(per.values()) <= 0:
        raise AssertionError(f"{label}: {sites} quantized GEMMs in the forward, "
                             f"{eng.quant_gemms} in calibration")
    wide = [r["in_shape"] for r in log if r["kind"] == "pack" and r["layout"] == "im2col"
            and ig.implicit(r["in_shape"][1])]
    if wide:  # every conv with C >= 32 runs as an implicit GEMM, without im2col rows
        raise AssertionError(f"{label}: explicit im2col packs of wide convs: {wide[:3]}")
    for name, n in per.items():
        if counts[name] != n * n_requests:
            raise AssertionError(f"{label}: {name} launched {counts[name]} times, "
                                 f"expected {n} x {n_requests}")
    return per, log


def phase_int8(shapes, pairs, xl_bf16_disps):
    """XL int8 at 1216x1024 (4 requests, profiled), then S int8a and int8r
    (2 requests each). Returns (launches, the XL forward's site log)."""
    import torch
    from s2m2_torch.runtime.engine import StereoEngine

    launches = Counter()
    s_forward = {k: sum(v.values()) for k, v in shapes.items()}
    runs = [("XL", "int8", pairs[:N_XL_REQUESTS], XL_LAUNCHES[False]),
            ("S", "int8a", pairs[:N_INT8_S_REQUESTS], s_forward),
            ("S", "int8r", pairs[:N_INT8_S_REQUESTS], s_forward)]
    xl_log = None
    for model, precision, run_pairs, per_forward in runs:
        eng = StereoEngine(model, precision=precision, seed=0)
        t0 = time.perf_counter()
        left, right = run_pairs[0]
        eng._auto_calibrate(left[None], right[None])  # what run() does first
        calib_s = time.perf_counter() - t0
        label = f"{model} {precision}"
        ms, disps, counts, peak = serve(eng, label, run_pairs, per_forward)
        per, log = _int8_counts(eng, label, counts, len(run_pairs))
        launches.update(counts)
        med = float(np.median(ms))
        rec = {"phase": "int8_path", "model": model, "precision": precision,
               "height": H, "width": W, "requests": len(run_pairs), "ms_per_frame": ms,
               "median_ms": med, "fps": 1e3 / med, "max_memory_allocated": peak,
               "calibration_s": calib_s, "sites": len(eng.quant_scales),
               "quantized_gemms": eng.quant_gemms, "e_launches_per_forward": per,
               "launches": counts}
        if model == "XL":
            xl_log = log
            delta = [float(np.abs(a - b).mean()) for a, b in zip(disps, xl_bf16_disps)]
            rec["mean_abs_disp_diff_vs_bf16_unfused_px"] = float(np.mean(delta))
            emit({**profile_forward(eng, precision, *run_pairs[0]), "model": model})
        emit(rec)
        del eng
        torch.cuda.empty_cache()
    return launches, xl_log


def _site_pack_inputs(g, rec):
    """(x, kwargs) of one pack record: a seeded float input of its shape."""
    import torch
    dt = torch.bfloat16 if rec["dtype"] == "torch.bfloat16" else torch.float32
    x = torch.randn(rec["in_shape"], generator=g, device="cuda").to(dt)
    layout = rec["layout"]
    kw = {"nhwc": True} if layout == "nhwc" else {"conv": rec["conv"]}
    if layout == "im2col":
        kw["rows"] = (0, rec["rows"])
    return x, kw


def _site_gemm_inputs(g, rec):
    """(a, w) of one GEMM record, seeded int8 with the padded columns (or
    padded channels of the NHWC tensor) zero, as the packs leave them."""
    import torch
    n, k, kp, conv = rec["n"], rec["k"], rec["kp"], rec["conv"]
    a = torch.randint(-127, 128, rec["a_shape"], generator=g, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, kp), generator=g, device="cuda", dtype=torch.int8)
    if conv is None:
        a[:, k:] = 0
        w[:, k:] = 0
    else:
        c = k // (conv[0] * conv[1])
        a[..., c:] = 0
        w.view(n, conv[0] * conv[1], -1)[:, :, c:] = 0
    return a, w


def _device_ms(fn):
    """Device-bound time of one call: CUDA events over 10 back-to-back calls
    (the host's dispatch then overlaps the work queued before it)."""
    return time_ms(fn, n=10, reps=10)


def phase_int8_sites(log):
    """Kernel E at every distinct site shape of one XL int8 forward (from the
    forward's own record), each against its plain version: the packed int8
    (token rows, NHWC tensor or explicit im2col rows) bit-equal; the GEMM's
    int32 accumulators bit-equal and its output within one ulp, in row mode
    and in conv mode (implicit GEMM). Times per forward (each shape's median
    times its launches): `ms` over 10 back-to-back calls (the device's
    time), `ms_single` over one call (which includes the host's dispatch
    when that is longer); torch._int_mm, which the port never calls, on
    int8 rows of the explicit im2col width at every shape it accepts, timed
    the same two ways. Bounds: each kernel's own share of the sites' work
    (the pack: the activation read once; the GEMM: weight, output, scales
    and operations) and `site_bound_ms`, the bound of each site's work
    taken whole (`site_work`), the same whatever the design. Returns the two
    kernels-line entries; with --out DIR the per-shape records go to
    DIR/int8_sites.json."""
    import torch
    from s2m2_torch.ops import int8_gemm as ig
    from s2m2_torch.tools.chip_probe import site_work
    g = torch.Generator(device="cuda").manual_seed(0)
    size = {"torch.bfloat16": 2, "torch.float32": 4}
    packs, gemms = Counter(), Counter()
    recs_of = {}
    for r in log:
        if r["kind"] == "pack":
            key = (r["layout"], tuple(r["in_shape"]), r["conv"], r["rows"], r["dtype"])
        elif r["kind"] == "gemm":
            key = (tuple(r["a_shape"]), r["n"], r["k"], r["kp"], r["out"], r["nchw"],
                   r["conv"], r["m"])
        else:
            continue
        (packs if r["kind"] == "pack" else gemms)[key] += 1
        recs_of.setdefault(key, r)
    recs = []
    for key, count in packs.items():
        r = recs_of[key]
        x, kw = _site_pack_inputs(g, r)
        inv = 20.0
        got = ig.quantize_pack(x, inv, **kw)
        ok = torch.equal(got, ig.quantize_pack_plain(x, inv, **kw))
        in_bytes = site_work([r])[0][0] - (r["rows"] * r["kp"])  # the activation's share
        kern = lambda: ig.quantize_pack(x, inv, **kw)  # noqa: E731, B023
        recs.append({"kernel": "int8_quantize_pack", "layout": r["layout"],
                     "in_shape": list(r["in_shape"]), "conv": r["conv"], "rows": r["rows"],
                     "k": r["k"], "kp": r["kp"], "per_forward": count, "ok": ok,
                     "ms": _device_ms(kern), "ms_single": time_ms(kern, n=10),
                     "plain_ms": time_ms(lambda: ig.quantize_pack_plain(  # noqa: B023
                         x, inv, **kw), n=3, warmup=1),
                     "bound_ms": 1e3 * in_bytes / PEAK_BYTES, "by_bytes": True,
                     "max_abs_err": 0.0 if ok else float("inf")})
        del x, got
    for key, count in gemms.items():
        r = recs_of[key]
        m, n, k, conv = r["m"], r["n"], r["k"], r["conv"]
        dt = torch.bfloat16 if r["out"] == "torch.bfloat16" else torch.float32
        a, w = _site_gemm_inputs(g, r)
        s_w = torch.rand((n,), generator=g, device="cuda") * 1e-4
        bias = torch.randn((n,), generator=g, device="cuda")
        o = None
        if r["nchw"]:
            ho, wo = (ig.conv_out_hw(a.shape[1], a.shape[2], conv) if conv
                      else (1, m))
            o = torch.empty((m // (ho * wo), n, ho, wo), dtype=dt, device="cuda")
        acc = ig.int8_gemm(a, w, out_dtype=torch.int32, conv=conv)
        acc_ok = torch.equal(acc, ig.int8_gemm_plain(a, w, out_dtype=torch.int32, conv=conv))
        got = ig.int8_gemm(a, w, s_w, 0.01, bias, dt, out=o, conv=conv)
        got = got.permute(0, 2, 3, 1).reshape(m, n) if r["nchw"] else got
        ref = ig.int8_gemm_plain(a, w, s_w, 0.01, bias, dt, conv=conv)
        diff = (got.float() - ref.float()).abs()
        big = torch.maximum(got.float().abs(), ref.float().abs()).clamp(min=1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - (7 if dt == torch.bfloat16 else 23))
        ok = acc_ok and bool((diff <= ulp).all())
        del acc, got, ref, diff, big, ulp
        lib = lib_single = None
        kpad = ig.k_padded(k)
        if m > 16 and n % 8 == 0:  # torch._int_mm on the explicit im2col rows' shape
            rows = torch.randint(-127, 128, (m, kpad), generator=g, device="cuda",
                                 dtype=torch.int8)
            wt = torch.randint(-127, 128, (n, kpad), generator=g, device="cuda",
                               dtype=torch.int8).t()
            try:
                torch._int_mm(rows, wt)
                lib = _device_ms(lambda: torch._int_mm(rows, wt))  # noqa: B023
                lib_single = time_ms(lambda: torch._int_mm(rows, wt), n=10)  # noqa: B023
            except RuntimeError:
                pass
            del rows, wt
        nbytes = n * k + m * n * size[r["out"]] + 8 * n
        ops = 2 * m * n * k
        kern = lambda: ig.int8_gemm(a, w, s_w, 0.01, bias, dt, out=o, conv=conv)  # noqa: E731, B023
        gather = (conv is not None and tuple(conv) != (1, 1, 1, 1, 0, 0)
                  and not ig.tap_tiles(conv, r["a_shape"][3]))
        p = ig.plan("int8", m, n, torch.cuda.get_device_properties(0).multi_processor_count,
                    gather)
        recs.append({"kernel": "int8_gemm", "m": m, "n": n, "k": k, "kp": r["kp"],
                     "conv": conv, "a_shape": list(r["a_shape"]), "out": r["out"],
                     "nchw": r["nchw"], "per_forward": count, "ok": ok,
                     "instance": p._asdict(), "max_abs_err": 0.0 if ok else float("inf"),
                     "ms": _device_ms(kern), "ms_single": time_ms(kern, n=10),
                     "plain_ms": time_ms(lambda: ig.int8_gemm_plain(  # noqa: B023
                         a, w, s_w, 0.01, bias, dt, conv=conv), n=3, warmup=1),
                     "library_ms": lib, "library_ms_single": lib_single,
                     "bound_ms": 1e3 * max(nbytes / PEAK_BYTES, ops / PEAK_FLOPS["int8"]),
                     "by_bytes": nbytes / PEAK_BYTES >= ops / PEAK_FLOPS["int8"]})
        del a, w
    torch.cuda.empty_cache()
    if OUT_DIR is not None:
        (OUT_DIR / "int8_sites.json").write_text(json.dumps(recs))
    bad = [r for r in recs if not r["ok"]]
    site_bound = sum(1e3 * max(b / PEAK_BYTES, o / PEAK_FLOPS["int8"])
                     for b, o in site_work(log))
    entries = {}
    for name in ("int8_quantize_pack", "int8_gemm"):
        mine = [r for r in recs if r["kernel"] == name]
        tot = lambda key, rs=mine: sum(r[key] * r["per_forward"] for r in rs)  # noqa: E731
        by_bytes = sum(r["bound_ms"] * r["per_forward"] for r in mine if r["by_bytes"])
        lib = [r for r in mine if r.get("library_ms") is not None]
        entries[name] = {
            "ms": tot("ms"), "ms_single": tot("ms_single"), "plain_ms": tot("plain_ms"),
            "bound_ms": tot("bound_ms"),
            "bound_by": "bytes" if 2 * by_bytes >= tot("bound_ms") else "operations",
            "site_bound_ms": site_bound,
            "library_ms": tot("library_ms", lib) if lib else None,
            "library_ms_single": tot("library_ms_single", lib) if lib else None,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "shapes": len(mine), "launches_per_forward": sum(r["per_forward"] for r in mine)}
        if name == "int8_quantize_pack":  # per forward: the path each site takes
            split = {}
            for r in log:
                if r["kind"] == "pack":
                    d = split.setdefault(r["layout"], {"launches": 0, "in_bytes": 0,
                                                       "int8_bytes": 0})
                    d["launches"] += 1
                    d["in_bytes"] += site_work([r])[0][0] - r["rows"] * r["kp"]
                    d["int8_bytes"] += r["rows"] * r["kp"]
            entries[name]["by_layout"] = split
        if lib:  # the GEMM's own time on the shapes torch._int_mm accepts
            entries[name]["ms_where_library"] = tot("ms", lib)
            entries[name]["launches_where_library"] = sum(r["per_forward"] for r in lib)
        emit({"phase": "kernels", "kernel": name, "at": "XL int8 1216x1024 site shapes",
              **entries[name]})
    if bad:
        raise AssertionError(f"kernel E disagrees with its plain version at "
                             f"{len(bad)} shapes: {bad[:3]}")
    return entries


def synthetic_calibration():
    """A sensor calibration at 1216x1024 (W x H): fx = fy ~ 1000, principal
    points near the centre and apart, 5 distortion coefficients a camera,
    a -120 mm baseline and a stereo rotation of a few mrad."""
    from s2m2_torch.utils.calib import euler_to_rotation_matrix
    return {
        "left": {"fx": 1000.0, "fy": 1000.0, "cx": 611.3, "cy": 509.2,
                 "distortion": np.array([-0.05, 0.012, 0.0004, -0.0003, 0.001])},
        "right": {"fx": 1001.5, "fy": 1001.5, "cx": 604.8, "cy": 514.6,
                  "distortion": np.array([-0.048, 0.011, -0.0002, 0.0005, 0.0])},
        "stereo_extrinsic": {"rotation": euler_to_rotation_matrix(0.002, -0.003, 0.0015),
                             "translation": np.array([-120.0, 0.3, -0.5])},
    }


def phase_native(raw, calib, native_seconds):
    """The native host library against its numpy versions at the path's
    sizes: both raw images remapped with the port's maps (<= 1 grey level),
    the blurred pad of a 1200x1000 frame (<= 1e-3); host ms of each."""
    from s2m2_torch import native
    from s2m2_torch.utils.calib import compute_stereo_rectification
    from s2m2_torch.utils.image import image_pad_plain, remap_plain
    t0 = time.perf_counter()
    rect = compute_stereo_rectification(calib, (W, H))
    maps_ms = (time.perf_counter() - t0) * 1e3
    rec = {"phase": "native", "build_seconds": native_seconds, "maps_ms": maps_ms}
    worst = 0
    for img, side in zip(raw, ("left", "right")):
        mx, my = rect[f"{side}MapX"], rect[f"{side}MapY"]
        t0 = time.perf_counter()
        got = native.remap_bilinear(img, mx, my)
        t1 = time.perf_counter()
        want = remap_plain(img, mx, my)
        t2 = time.perf_counter()
        worst = max(worst, int(np.abs(got.astype(int) - want.astype(int)).max()))
        rec[f"remap_{side}_ms"], rec[f"remap_{side}_plain_ms"] = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    frame = np.random.default_rng(1).uniform(0, 255, (1, 1000, 1200, 3)).astype(np.float32)
    t0 = time.perf_counter()
    padded = native.image_pad(frame[0])
    t1 = time.perf_counter()
    want = image_pad_plain(frame)[0]
    t2 = time.perf_counter()
    pad_err = float(np.abs(padded - want).max())
    ok = worst <= 1 and pad_err <= 1e-3 and padded.shape == (1024, 1216, 3)
    emit({**rec, "remap_max_diff": worst, "remap_bound": 1, "pad_max_abs_err": pad_err,
          "pad_bound": 1e-3, "pad_ms": (t1 - t0) * 1e3, "pad_plain_ms": (t2 - t1) * 1e3,
          "ok": ok})
    if not ok:
        raise AssertionError(f"native library disagrees with its numpy versions: remap "
                             f"{worst} grey levels, pad {pad_err}")


def _search(label, fn, per_forward):
    """Run one calibration search, fn(candidate_log), with the launch counts
    set to 0 just before; check and report it. Returns its counts."""
    from s2m2_torch.ops import _build
    log = []
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = fn(log)
    wall = time.perf_counter() - t0
    counts = dict(_build.launch_counts)
    n = len(log)
    zeros = [r for r in log if r["score"] == 0.0]
    med = {k: float(np.median([r[k] for r in log])) for k in ("maps_ms", "remap_ms", "score_ms")}
    emit({"phase": "calibration", "search": label, "candidates": n, "wall_s": wall,
          "median_maps_ms": med["maps_ms"], "median_remap_ms": med["remap_ms"],
          "median_request_ms": med["score_ms"],
          "host_share": (med["maps_ms"] + med["remap_ms"]) / sum(med.values()),
          "initial_confidence": res["initial_confidence"],
          "final_confidence": res["final_confidence"],
          "deltas": [res["roll_delta"], res["pitch_delta"], res["yaw_delta"]],
          "zero_scores": len(zeros), "launches": counts})
    if n == 0 or zeros:
        raise AssertionError(f"{label}: {len(zeros)} of {n} candidates scored 0.0: "
                             f"{[r.get('error') for r in zeros][:3]}")
    for name, k in per_forward.items():
        if counts[name] != k * n:
            raise AssertionError(f"{label}: {name} launched {counts[name]} times, "
                                 f"expected {k} x {n} candidates")
    return counts


def phase_calibration(shapes, pair, native_seconds):
    """Online self-calibration on the S bf16 engine (phase 8 above).
    Returns the launches of its runs."""
    import torch
    from s2m2_torch.calibration.cem import cem_calibration
    from s2m2_torch.calibration.grad_descent import gradient_descent_calibration
    from s2m2_torch.ops import _build
    from s2m2_torch.runtime.engine import StereoEngine
    from s2m2_torch.tools import bench
    from s2m2_torch.utils.calib import compute_stereo_rectification
    from s2m2_torch.utils.image import rectify_images

    per_forward = {k: sum(v.values()) for k, v in shapes.items()}
    raw = [np.rint(img).astype(np.uint8) for img in pair]
    calib = synthetic_calibration()
    phase_native(raw, calib, native_seconds)
    eng = StereoEngine("S", precision="bf16", seed=0)
    launches = Counter()
    launches.update(_search("cem", lambda log: cem_calibration(
        eng, *raw, calib, seed=0, verbose=False, candidate_log=log), per_forward))
    launches.update(_search("gradient_descent", lambda log: gradient_descent_calibration(
        eng, *raw, calib, verbose=False, max_iterations=1, candidate_log=log), per_forward))

    # n_repeat: one forward, then one warm and 4 timed, on the rectified pair
    left_r, right_r = rectify_images(*raw, compute_stereo_rectification(calib, (W, H)))
    _build.reset_launch_counts()
    one = eng.run(left_r, right_r, n_repeat=1)
    four = eng.run(left_r, right_r, n_repeat=4)
    counts = dict(_build.launch_counts)
    launches.update(counts)
    diff = float(np.abs(one[0] - four[0]).mean())
    ok = diff < 0.01 and all(counts[k] == 6 * n for k, n in per_forward.items())
    emit({"phase": "n_repeat", "ms_n_repeat_1": one[4], "ms_n_repeat_4": four[4],
          "mean_abs_disp_diff_px": diff, "bound_px": 0.01, "launches": counts, "ok": ok})
    if not ok:
        raise AssertionError(f"run(n_repeat=4) differs from run(n_repeat=1) by {diff} px "
                             f"or launched {counts}")
    del eng
    torch.cuda.empty_cache()

    _build.reset_launch_counts()  # the bench: 2 warm and 5 timed forwards
    bench.main(["--model", "S", "--precision", "bf16", "--iters", "5"])
    counts = dict(_build.launch_counts)
    if any(counts[k] != 7 * n for k, n in per_forward.items()):
        raise AssertionError(f"bench launched {counts}, expected 7 forwards")
    launches.update(counts)
    torch.cuda.empty_cache()
    if any(m == "cv2" or m.startswith("cv2.") for m in sys.modules):
        raise AssertionError("the calibration path imported cv2")
    return launches


def _forward_sums(recs):
    """Each shape's times x its launches per forward, summed over `recs`."""
    tot = lambda key: sum(r[key] * r["per_forward"] for r in recs)  # noqa: E731
    by_bytes = sum(r["bound_parts_ms"][0] * r["per_forward"] for r in recs)
    # operations: flops or, for kernel C, exponentials, whichever is larger
    by_ops = sum(max(r["bound_parts_ms"][1:]) * r["per_forward"] for r in recs)
    sums = {"ms": tot("ms"), "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None if recs[0]["library_ms"] is None else tot("library_ms"),
            "launches_per_forward": sum(r["per_forward"] for r in recs)}
    parts = zip(*[r["bound_parts_ms"] for r in recs])
    sums["bound_parts_ms"] = dict(zip(("bytes", "operations", "exps"), (
        sum(p * r["per_forward"] for p, r in zip(part, recs)) for part in parts)))
    for key in ("unfused_ms", "ms_single", "library_ms_single"):
        if key in recs[0]:
            sums[key] = tot(key)
    if "plan" in recs[0]:
        sums["plan"] = recs[0]["plan"]
    return sums


def kernels_line(results, launches):
    """One entry per kernel. ms, plain_ms, library_ms and bound_ms are sums
    over the launches of one bf16 1216x1024 forward (each shape's time times
    its launches per forward): an S forward for A, B and C, an XL forward
    with the fused block on for D (which adds unfused_ms, the port's unfused
    blocks on the same rows); `fp32` holds the same sums in float32. A, B and
    C add `xl` (and `xl_fp32`): the sums over an XL forward with the fused
    block off. max_abs_err is the largest over all of the kernel's
    comparisons; launches counts every main-path request of phases 5-8."""
    out = []
    for name, by_dtype in results.items():
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "launches": launches[name]}
        main_model = "XL" if name == "fused_basic_attn_block" else "S"
        for dn, recs in by_dtype.items():
            sums = _forward_sums([r for r in recs
                                  if r["per_forward"] > 0 and r["model"] == main_model])
            sums["max_abs_err"] = max(c["max_abs_err"] for r in recs for c in r["checks"])
            xl = [r for r in recs if r["model"] == "XL"]
            if dn == "bfloat16":
                entry.update(sums)
                if name in XL_TIMED:
                    entry["xl"] = _forward_sums(xl)
            else:
                entry["fp32"] = sums
                if name in XL_TIMED:
                    entry["xl_fp32"] = _forward_sums(xl)
        out.append(entry)
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    if not (ROOT / "s2m2_torch" / "csrc").is_dir():
        print(f"chip_smoke: no s2m2_torch package beside {__file__}; run it from "
              "the root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from s2m2_torch.config import get_config

    # float32 comparisons are exact-float32 on both sides: no TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    global OUT_DIR
    if "--out" in sys.argv[1:-1]:
        OUT_DIR = Path(sys.argv[sys.argv.index("--out") + 1])
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        (OUT_DIR / "chip_smoke.jsonl").write_text("")
    t0 = time.perf_counter()
    smi = phase_device()
    native_seconds = phase_build()
    shapes = main_path_shapes(get_config("S"), H, W)
    xl_blocks = main_path_shapes(get_config("XL"), H, W, fused_block=True)
    with torch.inference_mode():
        xl_unfused = main_path_shapes(get_config("XL"), H, W, fused_block=False)
        results = phase_kernels({**shapes, "fused_basic_attn_block":
                                 xl_blocks["fused_basic_attn_block"]},
                                {k: xl_unfused[k] for k in XL_TIMED})
        phase_probe()
    phase_golden(fused_block=False)
    phase_golden(fused_block=True)
    phase_golden_int8()
    rng = np.random.default_rng(0)
    pairs = [_stereo_pair(rng, H, W, 16 + 8 * i) for i in range(N_REQUESTS)]
    launches = phase_main_path(shapes, pairs)
    xl_launches, xl_bf16_disps = phase_xl(pairs[:N_XL_REQUESTS])
    launches.update(xl_launches)
    int8_launches, xl_int8_log = phase_int8(shapes, pairs, xl_bf16_disps)
    launches.update(int8_launches)
    with torch.inference_mode():
        e_entries = phase_int8_sites(xl_int8_log)
    launches.update(phase_calibration(shapes, pairs[0], native_seconds))
    line = kernels_line(results, launches)
    for name, entry in e_entries.items():
        line.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": launches[name], **entry})
    for entry in line:
        if entry["launches"] <= 0:
            raise AssertionError(f"{entry['name']} was not launched on the main path")
    print(json.dumps({"kernels": line}))
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
