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
   the same rows (float32 bounds of A, B and D by split TF32); F (the int8
   attention core of the int8_attn opt-in, 10 back-to-back calls a sample)
   at the shapes one S and one XL int8_attn forward give it
   (`int8_attn_shapes`: N = 304, 152, 76 and the 1216-token map), each
   record naming the `ops.int8_attention.plan` that ran, each row within two
   probability quanta of its plain version (2 s_v pmax_row) plus the
   rounding, and at most 1% of the elements beyond the rounding
   (`ops.int8_attention.agreement`), a repeat launch and the custom op's
   launch bitwise equal to the first, its bound in bytes and int8
   operations; then E's bf16-accumulator
   epilogue (int8_acc_bf16) within one ulp of its plain version at three
   S geometries (`E_ACC_BF16_CASES`), timed beside the int32 epilogue;
   then G (`phase_conv`, the split-TF32 float32 conv of kernel
   `csrc/conv_tf32x3.cu`) at every distinct shape it takes in an S, an XL
   and a RAFT-Stereo (the published defaults, 32 iterations) float32
   1216x1024 forward (`conv_shapes`; the 1x1 ones on G's flat path, kept
   apart in the records): its largest error and its
   plain version's against a float64 conv of the same seeded operands,
   each over the largest |output| (G's bound 1e-5: float32's rounding is
   about 1e-6 there, one TF32 pass about 1e-3), and G timed in turns with
   F.conv2d in float32 with TF32 off (cuDNN, the yardstick the port no
   longer calls for these convs: cuDNN, G, G, cuDNN, CUDA events, median
   of 10); its bound is the operations at 165 TFLOP/s (split TF32) or the
   bytes at 3.35 TB/s; then one S, one XL and one RAFT-Stereo float32
   forward, whose G launches (`conv_tf32x3`, `conv1x1_tf32x3`) must each
   equal the forward's routed convs;
4. golden: the port on the card, kernels engaged, float32 with TF32 off, on
   every tests/golden/s2m2_*.npz against the reference outputs, with the
   fused block off and then on (kernel D engaged); then int8 and int8r,
   and int8 with each opt-in (`GOLDEN_OPTINS`: the drift on the pair alone
   and the mean over the pair and four 1e-6 relative changes of it, F
   launched only with int8_attn);
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
   forward; then S in int8a and int8r, 2 requests each; then S int8 alone,
   with int8_attn and with int8_acc_bf16, 8 requests each, with their mean
   |d disp| against phase 5's S fp32 and bf16 disparities. Each run checks
   A, B and C against the counts of phase 5/6 (A and B at 0 with
   int8_attn, whose cores run on F), D at 0 (the fused route is off),
   every quantized GEMM of the calibration pass served by kernel E, and
   E's and F's launches against the forward's own record of its sites;
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
   5`, and a check that cv2 was never imported;
9. train: the port's training on the card. (1) A, B and C with grad
   enabled at the shapes an S step at batch 2 x 384x512 gives them, in
   float32 and bf16: one launch each (their autograd Functions) and
   gradients equal to autograd through the plain versions; D and E raise
   under grad. (2) One fp32 step of CH32/NTR1/refine_iter=2 at 96x128,
   batch 2, TF32 off, on the card and on the CPU from the same seeded
   weights and batch: loss, every gradient leaf, no silent gradient stop,
   parameters after the step. (3) `train()` on S at full width, bf16 over
   fp32 masters, batch 2 at 384x512 (the JAX loader's default crop),
   synthetic scenes (max_disp 64) through `augment_batches`, 20 steps at lr
   2e-4 with 2 warmup steps: ms per step by CUDA events, peak memory, the
   losses, A/B/C launched 20/10/1 per step and D, E never; then one
   profiled step, device ms by kernel family for the forward and the
   backward, and the backward's ms in A's, B's and C's plain recompute.
   (4) XL, the same at batch 1, 3 steps. (5) The checkpoint written after
   S's last step restored into a fresh model and optimizer: one more step
   from both, deterministic algorithms on, parameters bitwise equal. (6)
   `tools/calibrate.py` for S int8 writes the scale cache; an engine that
   loads it gives the scales and, on phase 5's first pair, the disparity
   of an engine that calibrated itself.
10. export: `torch.export` programs (.pt2, s2m2_torch/tools/export.py) of
   the main path at 1216x1024 with phase 5's pairs and seeded weights (seed
   0), each exported on the card, saved to a temporary directory, loaded
   and served: (a) S bf16 with its weights embedded, (b) XL bf16 with the
   fused block, weight-free (the state dict an argument), (c) XL int8 from
   phase 7's calibration (its scales baked in, the prequantized weights an
   argument). Each prints export, save and load seconds, the file's MB, the
   max |disp| against the live model with the same casts (bound 1e-3 px;
   the same kernels run, so 0.0 is expected), ms per request through the
   program beside the live model's, in turns, and A-E's launches per call,
   which must equal the live forward's: (a) A/B/C 20/10/1; (b) A/B/C/D
   32/18/1/12; (c) A/B/C 44/30/1 and E's packs and GEMMs as the live int8
   forward logs them (a plain version traced into the program would show
   as a missing launch). (a) is also loaded and run in a subprocess that
   imports only s2m2_torch.tools.export, which must load no jax, s2m2_tpu
   or s2m2_torch.models module (it runs while (b) is exported and ends
   before (b)'s requests).
11. entry points: the five demo CLIs as a user runs them, each in its own
   process on the card at its defaults, on the synthesized inputs of
   `s2m2_torch/demo/_scenes.py` (1216x1024): `visualize_2d_simple` (S bf16,
   run(n_repeat=5)), `visualize_3d_middlebury` (L), `visualize_3d_booster`
   (XL, 2432x2048 halved), `online_calibration --method cem` (S) and
   `train_demo` (the tiny config); then `python -m
   s2m2_torch.tools.train_convergence --bf16` for CONVERGENCE_STEPS steps,
   held-out evaluation at step 0 and at the end (fails on a non-finite
   loss or a final held-out EPE or bad-2.0 above its bound). Each process
   runs through this script's `--cli` wrapper, which counts the model's
   forwards; the phase fails if a process exits non-zero, loaded cv2, PIL,
   jax or s2m2_tpu, or launched A, B and C other than its model's counts
   a forward (S 20/10/1, XL unfused 44/30/1, L's and the tiny configs' from
   their shapes) or D or E at all. One line per process: wall seconds, the
   ms it printed (the 2D demo's beside phase 5's S bf16 median, the
   Booster demo's beside phase 6's XL bf16 unfused median), its output's
   size (panel bytes, PLY points), the convergence run's EPE, bad-2.0 and
   ms per step.
12. parallel: the port's ('data', 'band') mesh (s2m2_torch/parallel/) on 2
   ranks, each a process of this script's `--rank` mode. With one card both
   ranks use it and talk over gloo on host copies (the host transport, so
   the times are not a scaling figure); with two or more cards each rank
   has its own and they talk over NCCL. The transport is printed. Cells, S
   at 1216x1024 on phase 5's pairs, 3 requests each after one untimed:
   fp32 on a 1x2 mesh (bands of 512 rows), bf16 on 1x2 and on 2x1 (two
   pairs a request), bf16 with the fused block on 1x2 (D runs sharded),
   int8 on 1x2 (calibrated on the full frames on every rank). Rank 0 also
   serves the unsharded engine on the same requests (twice the first, to
   show it is deterministic) and holds the sharded outputs to it with
   fixed bounds (`PARALLEL_BOUNDS`): fp32 max |d disp| <= 1e-3 px, occ <=
   1e-4, conf <= 6.8e-3; bf16 mean |d disp| <= 0.026 px. The last two are
   twice the largest change a 1e-6 relative input change makes in the
   unsharded forward (`s2m2_torch/tools/chip_probe.py sensitivity`), above
   the planned 1e-4 and 0.01 px, which the line reports as met or not.
   int8 follows the JAX int8 test's rule: max below the larger of 0.02 and
   twice the unsharded disparity's change under a 1e-6 relative change of
   each request's left image, the 99th percentile below half of that. Per
   rank and forward A/B/C (and D, E where they run) launch what the
   unsharded forward launches, and the band collectives (halo exchanges,
   all-reduces, all-gathers) equal `parallel.band.expected_counts`. Each
   distinct shape the sharded forwards give kernels A-D is held to its
   plain version with phase 3's seeded inputs and tolerances, and E at the
   band-sharded conv geometries (row padding 0). Then data-parallel
   training at 2x1 (CH32, batch 2, 3 steps) against one process: loss
   within 1e-4 relative, each gradient leaf within 1e-3 of its max + 1e-9.
   Then a band-sharded training step of S on 1x2 (`_band_train_check`:
   256x384, batch 2, bf16 over fp32 masters, then fp32) against the
   unsharded step: per rank the forward's and backward's collectives equal
   `band.expected_counts(cfg, backward=True)` and A/B/C launch the
   unsharded step's counts; fp32 loss within 1e-4 relative, gradient 1e-5
   relative L2, each leaf within 1e-3 of its max + 1e-9 (or, a leaf under
   1e-3 of the whole norm, 2e-6 of the whole norm); bf16 loss and gradient
   (relative L2) within twice what a 1e-6 relative change of the left
   images moves the unsharded bf16 step (at least 1e-4 and 1e-3), and each
   leaf within four times that change of the leaf + one bf16 ulp (2^-7) of
   the ranks' summed |partial gradients| (each partial is a bf16 reduction
   over its band, rounded before the sum) + 1e-6 of the whole norm.
   One line per cell and rank: ms per request (the slowest rank's) beside
   the unsharded median, launches and collectives per forward and the
   bytes each kind moved.

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

import contextlib
import glob
import json
import os
import re
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
# kernels timed over 10 back-to-back calls (A, B and C keep one call as
# ms_single) and also at every shape of an XL forward with the fused block
# off (F: of an XL int8_attn forward)
XL_TIMED = (*ATTENTION, "fused_correlation_ot", "int8_attention")
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
    # no Pallas kernel: the int8_attn opt-in's core, which XLA compiles
    "int8_attention": "s2m2_tpu/models/quant.py:369",
}
SOURCES = {
    "scanline_attention": "s2m2_torch/csrc/scanline_attention.cu",
    "scanline_cross_attention": "s2m2_torch/csrc/scanline_attention.cu",
    "fused_correlation_ot": "s2m2_torch/csrc/sinkhorn_ot.cu",
    "fused_basic_attn_block": "s2m2_torch/csrc/fused_basic_attn_block.cu",
    "int8_quantize_pack": "s2m2_torch/csrc/int8_gemm.cu",
    "int8_gemm": "s2m2_torch/csrc/int8_gemm.cu",
    "int8_attention": "s2m2_torch/csrc/int8_attention.cu",
}
N_INT8_S_REQUESTS = 2
# the JAX package's int8 drift bounds (tests/test_quant.py:186-191)
GOLDEN_INT8 = (("s2m2_c32_ntr1.npz", "int8", 0.01), ("s2m2_c32_ntr1_neg_up.npz", "int8", 0.08),
               ("s2m2_c32_ntr1.npz", "int8r", 0.015),
               ("s2m2_c32_ntr1_neg_up.npz", "int8r", 0.09))
# the int8 opt-ins on the same fixtures, at the JAX package's bounds
# (tests/test_quant.py:186-191 with int8_attn, :211-218 with int8_acc_bf16);
# held both on the pair alone and as the mean over the pair and four 1e-6
# relative changes of it (tests/test_torch_int8_optins.py)
GOLDEN_OPTINS = (("s2m2_c32_ntr1.npz", "int8_attn", 0.01),
                 ("s2m2_c32_ntr1_neg_up.npz", "int8_attn", 0.08),
                 ("s2m2_c32_ntr1.npz", "int8_acc_bf16", 0.02),
                 ("s2m2_c32_ntr1_neg_up.npz", "int8_acc_bf16", 0.09))
OUT_DIR = None  # --out DIR: also keep the run's records there
# phase 9: S training at the JAX loader's default crop
# (s2m2_tpu/train/data.py:64, directory_batches), batch 2, 20 steps; XL 3
TRAIN_H, TRAIN_W, TRAIN_BATCH = 384, 512, 2
TRAIN_STEPS, XL_TRAIN_STEPS = 20, 3
TRAIN_LR, TRAIN_WARMUP = 2e-4, 2
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


def int8_attn_shapes(cfg, h, w):
    """The Counter of q shapes (B, N, d) that one int8_attn forward at (h, w)
    (batch 1) gives kernel F; each call's k and v have q's shape. The
    scanline blocks with one head run each core whole (self on both views,
    cross as two calls of one view each), the multi-head ones one head at a
    time; the 2D blocks without PE, whole: the MRT's (cross and self), the
    pyramid's decoder blocks, the refiners' bottlenecks."""
    h4, w4, c, nh, ntr = h // 4, w // 4, cfg.feature_channels, cfg.num_heads, \
        cfg.num_transformer
    tokens = (h4 // 8) * (w4 // 8)
    shapes = Counter()
    for hs, ws, ds, heads in ((h4, w4, c, nh), (h4 // 2, w4 // 2, c, 2 * nh),
                              (h4 // 4, w4 // 4, 2 * c, 4 * nh)):
        d = ds // heads
        shapes[(2 * hs, ws, d)] += 2 * ntr * heads          # self, both views
        shapes[(hs, ws, d)] += 2 * 2 * ntr * heads          # cross, x->y and y->x
    g, d = 8 * nh, 2 * c // (8 * nh)
    shapes[(2 * g, tokens, d)] += 4 * ntr                   # MRT 2D self
    shapes[(g, tokens, d)] += 2 * 4 * ntr                   # MRT 2D cross
    shapes[(2 * 8, tokens, 2 * c // 8)] += 2 * ntr          # pyramid decoder blocks
    shapes[(8, tokens, c // 8)] += 2                        # global refiner UNet
    shapes[(8, tokens, 2 * c // 8)] += 2 * cfg.refine_iter  # local refiner UNet
    return shapes


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
    # F: q, k, v read and the output written once in their dtype; its two
    # products are int8 operations
    return ndir * 4 * b * n * d * isz, ndir * 4 * b * n * n * d


def bound(name, shape, dtype_name):
    """(bytes ms, operations ms[, exps ms]): the bytes over the memory rate,
    the flops over the peak rate for the dtype (split TF32's for A, B and D
    in float32) and, for kernel C, its exponentials over the SMs'
    exponential rate at their maximum clock; the bound is the largest."""
    nbytes, flops = cost(name, shape, dtype_name)
    rate = PEAK_FLOPS["int8" if name == "int8_attention" else dtype_name]
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
    # kernel F: spills, and the compiler's notes on wgmma serialization
    f_notes = [ln.strip()[:160] for ln in
               (_build.BUILD_DIR / "int8_attention.log").read_text().splitlines()
               if re.search(r"[1-9]\d* bytes spill|C75(0\d|1[0-8]|2\d)", ln)]
    emit({"phase": "build", "seconds": seconds, "native_seconds": native_seconds,
          "ptxas": ptxas,
          "scanline_attention_spill_lines": spills, "int8_gemm_notes": gemm_notes[:40],
          "int8_gemm_note_count": len(gemm_notes), "int8_attention_notes": f_notes[:20]})
    if spills:
        raise AssertionError(f"scanline_attention instances spill: {spills}")
    return native_seconds


def _max_err_ok(got, ref, dtype_name, kind):
    """(max|diff|, bound description, ok) for one output. Kind "quanta"
    (kernel F): `ref` is F's inputs (q, k, v, s_q, s_k, s_v), and
    `ops.int8_attention.agreement` holds the output to its plain version
    (each row within two probability quanta, 2 s_v pmax_row, plus the
    rounding; few elements beyond the rounding)."""
    if kind == "quanta":
        from s2m2_torch.ops import int8_attention as ia
        res = ia.agreement(got, *ref)
        return res["max_abs_err"], f"{res['bound']}; share {res['flipped_share']:.3e}", \
            res["ok"]
    if kind in ("repeat", "custom_op"):
        import torch
        return float((got.float() - ref.float()).abs().max()), "bitwise equal", \
            bool(torch.equal(got, ref))
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


def _kernel_case(name, shape, dtype, g, **kw):
    """Seeded inputs of one kernel at one shape, as phase 3 makes them, and
    the kernel and its plain version on them: (checks [(kind, kernel's
    output, plain output)], kernel call, plain call, library call or None,
    the port's unfused block or None, the kernel's plan or None). Shapes
    as `main_path_shapes` gives them; `kw` goes to kernel C's calls."""
    import torch
    import torch.nn.functional as F
    from s2m2_torch.models.layers import layer_norm
    from s2m2_torch.ops import flash_attention as fa
    from s2m2_torch.ops import fused_block as fb
    from s2m2_torch.ops import sinkhorn

    dev = torch.device("cuda")
    unfused = None
    if name == "int8_attention":
        from s2m2_torch.ops import int8_attention as ia
        from s2m2_torch.ops import library  # noqa: F401  (registers the custom ops)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype) * f
                   for f in (1.0, 1.5, 2.0))
        sc = [float(x.float().abs().max()) / 127 for x in (q, k, v)]
        got = ia.int8_attention(q, k, v, *sc)
        # a repeat launch and the custom op (an exported program's launch)
        # give the same bits
        checks = [("quanta", got, (q, k, v, *sc)),
                  ("repeat", ia.int8_attention(q, k, v, *sc), got),
                  ("custom_op", torch.ops.s2m2_torch.int8_attention(q, k, v, *sc), got)]
        return checks, lambda: ia.int8_attention(q, k, v, *sc), \
            lambda: ia.int8_attention_plain(q, k, v, *sc), None, None, \
            ia.plan(shape[0], shape[1], shape[1], shape[2], dtype)._asdict()
    if name == "fused_basic_attn_block":
        n, w, c, heads = shape
        blk = seeded_block(c, heads).to(dev, dtype)
        wts = blk.fused_weights()
        rows = torch.randn((2 * n, w, c), generator=g, device=dev).to(dtype)
        got = fb.fused_basic_attn_block(rows, n, wts, heads)
        ref = torch.cat(fb.fused_basic_attn_block_plain(rows[:n], rows[n:], wts, heads))
        checks = [("block", got, ref)]
        kern = lambda: fb.fused_basic_attn_block(rows, n, wts, heads)  # noqa: E731
        plain = lambda: fb.fused_basic_attn_block_plain(  # noqa: E731
            rows[:n], rows[n:], wts, heads)
        unfused = lambda: blk.forward_rows(rows)  # noqa: E731  (blk.fused is off)
        return checks, kern, plain, None, unfused, fb.plan(w, c, c, heads, dtype)._asdict()
    if name == "fused_correlation_ot":
        f0, f1 = (layer_norm(torch.randn(shape, generator=g, device=dev)).to(dtype)
                  for _ in range(2))
        got = sinkhorn.fused_correlation_ot(f0, f1, **kw)
        ref = sinkhorn.fused_correlation_ot_plain(f0, f1, **kw)
        checks = [("prob", got[0], ref[0]), ("cv", got[1], ref[1])]
        kern = lambda: sinkhorn.fused_correlation_ot(f0, f1, **kw)  # noqa: E731
        plain = lambda: sinkhorn.fused_correlation_ot_plain(f0, f1, **kw)  # noqa: E731
        return checks, kern, plain, None, None, \
            sinkhorn.plan(shape[2], shape[3], dtype, True)._asdict()
    # B as the model calls it: the packed (x | y) batch, (2B, N, D)
    b = shape[0]
    if name == "scanline_cross_attention":
        b *= 2
        fn, plain_fn = fa.scanline_cross_attention_packed, fa.packed_cross_attention_plain
    else:
        fn, plain_fn = fa.scanline_attention, fa.scanline_attention_plain
    xs = [torch.randn((b, *shape[1:]), generator=g, device=dev).to(dtype) for _ in range(3)]
    checks = [("attn", fn(*xs), plain_fn(*xs))]
    # (B, 1, N, D) views: SDPA's fused backends take 4D inputs
    q4, k4, v4 = (x.unsqueeze(1) for x in xs)
    if name == "scanline_attention":
        lib = lambda: F.scaled_dot_product_attention(q4, k4, v4)  # noqa: E731
    else:
        h = b // 2
        lib = lambda: (  # noqa: E731
            F.scaled_dot_product_attention(q4[:h], k4[h:], v4[h:]),
            F.scaled_dot_product_attention(q4[h:], k4[:h], v4[:h]))
    return checks, lambda: fn(*xs), lambda: plain_fn(*xs), lib, None, \
        fa.plan(dtype, shape[-1])._asdict()


def phase_kernels(shapes, xl_shapes):
    """`shapes`: per kernel, the Counter of shapes (and launches per forward)
    of the S forward (D's: of the XL fused forward); `xl_shapes`: A's, B's
    and C's of the XL unfused forward, timed as well and tagged "XL"."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
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
                checks, kern, plain, lib, unfused, instance = _kernel_case(name, shape,
                                                                           dtype, g)
                torch.cuda.synchronize()
                errs = []
                for kind, a, b in checks:
                    err, limit, ok = _max_err_ok(a, b, dn, kind)
                    errs.append({"output": kind, "max_abs_err": err, "bound": limit,
                                 "ok": ok})
                    if not ok:
                        failures.append((name, shape, dn, kind, err, limit))
                reps = 10 if name in XL_TIMED else 1
                # F's plain version at XL's shapes (float64 products of up to
                # 512 x 304 x 304 x 384): fewer samples
                plain_kw = {"n": 5, "warmup": 1, "reps": 2} if (
                    name == "int8_attention" and model == "XL") else {"reps": reps}
                rec = {"kernel": name, "model": model, "shape": list(shape), "dtype": dn,
                       "per_forward": per_forward, "checks": errs,
                       "ms": time_ms(kern, reps=reps), "plain_ms": time_ms(plain, **plain_kw),
                       "library_ms": time_ms(lib, reps=reps) if lib else None,
                       "bound_ms": max(bound(name, shape, dn)),
                       "bound_parts_ms": bound(name, shape, dn)}
                if unfused is not None:  # the port's unfused block, A/B and cuBLAS
                    rec["unfused_ms"] = time_ms(unfused)
                if instance is not None and name in ATTENTION:
                    rec.update(instance=instance, ms_single=time_ms(kern),
                               library_ms_single=time_ms(lib))
                elif name in ("fused_correlation_ot", "int8_attention"):  # C, F: the plan
                    rec["plan"] = instance
                    if name == "fused_correlation_ot":
                        rec["ms_single"] = time_ms(kern)
                elif instance is not None:  # D: the plan's instance
                    rec["instance"] = instance
                emit({"phase": "kernels", **rec})
                results[name][dn].append(rec)
    if failures:
        raise AssertionError(f"kernel/plain disagreement: {failures}")
    return results


# kernel E's bf16-accumulator epilogue (int8_acc_bf16): (input, conv geometry
# or None, N, output dtype) at S's shapes: an MRT linear at 1/4 (the 2 x 256 x
# 304 tokens of both views, K = N = 128), a UNet 3x3 conv at 1/4 (taps by
# TMA) and a stride-2 3x3 conv (taps gathered), the last with float32 output
E_ACC_BF16_CASES = (((155648, 128), None, 128, "bfloat16"),
                    ((2, 128, 256, 304), (3, 3, 1, 1, 1, 1), 128, "bfloat16"),
                    ((1, 64, 128, 152), (3, 3, 2, 2, 1, 1), 64, "float32"))


def phase_e_acc_bf16():
    """Kernel E with the bf16-accumulator epilogue against its plain version
    (within one ulp of the output dtype) at E_ACC_BF16_CASES, timed (10
    back-to-back calls) beside the same call with the int32 epilogue, the
    plain version and, for rows, torch._int_mm (which the port never calls);
    bound: the int8 operands, the output and the scales once, and 2 M N K
    operations at the int8 rate."""
    import torch
    from s2m2_torch.ops import int8_gemm as ig
    g = torch.Generator(device="cuda").manual_seed(0)
    recs = []
    for shape, conv, n, dn in E_ACC_BF16_CASES:
        dt = getattr(torch, dn)
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        inv = ig.inv_scale(float(x.float().abs().max()) / 127.0)
        if conv is None:
            a = ig.quantize_pack(x, inv)
            depth, nchw, m = a.shape[1], None, a.shape[0]
        else:
            a = ig.quantize_pack(x, inv, nhwc=True)
            depth = conv[0] * conv[1] * a.shape[3]
            ho, wo = ig.conv_out_hw(shape[2], shape[3], conv)
            nchw, m = (shape[0], ho, wo), shape[0] * ho * wo
        w = torch.randint(-127, 128, (n, depth), generator=g, device="cuda", dtype=torch.int8)
        s_w = torch.rand((n,), generator=g, device="cuda") * 1e-3
        bias = torch.randn((n,), generator=g, device="cuda")
        def call(acc_bf16):  # this iteration's operands
            return ig.int8_gemm(a, w, s_w, 1 / inv, bias, dt, conv=conv,  # noqa: B023
                                nchw=nchw, acc_bf16=acc_bf16)  # noqa: B023
        got = call(True)
        want = ig.int8_gemm_plain(a, w, s_w, 1 / inv, bias, dt, conv=conv, acc_bf16=True)
        if nchw is not None:
            want = ig._rows_to_nchw(want, nchw)
        diff = (got.float() - want.float()).abs()
        big = torch.maximum(got.float().abs(), want.float().abs()).clamp(min=1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - (7 if dt == torch.bfloat16 else 23))
        ok = bool((diff <= ulp).all())
        lib = None
        if conv is None:
            wt = w.t()
            lib = _device_ms(lambda: torch._int_mm(a, wt))  # noqa: B023
        nbytes = m * depth + n * depth + m * n * dt.itemsize + 8 * n
        ops = 2 * m * n * depth
        recs.append({"phase": "kernels", "kernel": "int8_gemm", "epilogue": "acc_bf16",
                     "input": list(shape), "conv": conv, "n": n, "out": dn, "ok": ok,
                     "max_abs_err": float(diff.max()), "bound": "<= 1 ulp of the output",
                     "ms": _device_ms(lambda: call(True)),  # noqa: B023
                     "ms_int32_epilogue": _device_ms(lambda: call(False)),  # noqa: B023
                     "plain_ms": time_ms(lambda: ig.int8_gemm_plain(  # noqa: B023
                         a, w, s_w, 1 / inv, bias, dt, conv=conv, acc_bf16=True), n=3,
                         warmup=1),
                     "library_ms": lib,
                     "bound_ms": 1e3 * max(nbytes / PEAK_BYTES, ops / PEAK_FLOPS["int8"]),
                     "bound_by": "bytes" if nbytes / PEAK_BYTES >= ops / PEAK_FLOPS["int8"]
                     else "operations"})
        emit(recs[-1])
        del x, a, w, got, want, diff, big, ulp
    torch.cuda.empty_cache()
    bad = [r for r in recs if not r["ok"]]
    if bad:
        raise AssertionError(f"E's bf16-accumulator epilogue disagrees with its plain "
                             f"version: {bad}")
    return recs


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
    up, down = np.float32(1 + 1e-6), np.float32(1 - 1e-6)
    for fixture, optin, bound in GOLDEN_OPTINS:
        path = ROOT / "tests" / "golden" / fixture
        cfg, img0, img1, refs = golden_fixture(path)
        epes, counts = [], None
        for a, b in ((img0, img1), (img0 * up, img1), (img0 * down, img1),
                     (img0, img1 * up), (img0, img1 * down)):
            eng = StereoEngine(cfg, checkpoint=str(path), precision="int8", device="cuda",
                               **{optin: True})
            eng.calibrate(a, b)
            _build.reset_launch_counts()
            disp = eng.forward_padded(a, b)[0].cpu().numpy()
            counts = counts or {k: _build.launch_counts[k] for k in (*E_KERNELS,
                                                                    "int8_attention")}
            if not np.isfinite(disp).all():
                raise AssertionError(f"golden int8 {optin} on {fixture}: not finite")
            epes.append(float(np.abs(disp - refs[0]).mean()))
        f_ok = counts["int8_attention"] > 0 if optin == "int8_attn" else \
            counts["int8_attention"] == 0
        ok = bool(np.mean(epes) < bound and epes[0] < bound and
                  min(counts[k] for k in E_KERNELS) > 0 and f_ok)
        emit({"phase": "golden_int8", "fixture": fixture, "precision": "int8",
              "optin": optin, "epe": float(np.mean(epes)), "epe_pair": epes[0],
              "epe_runs": epes, "bound": bound, "sites": len(eng.quant_scales),
              "launches": counts, "ok": ok})
        if not ok:
            raise AssertionError(f"golden int8 {optin} failed on {fixture}: EPE {epes}, "
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
    launches, medians, disps = Counter(), {}, {}
    for precision in ("fp32", "bf16"):
        eng = StereoEngine("S", precision=precision, seed=0)
        ms, disps[precision], counts, peak = serve(eng, f"S {precision}", pairs, per_forward)
        launches.update(counts)
        med = medians[f"S {precision}"] = float(np.median(ms))
        emit(profile_forward(eng, precision, *pairs[0]))
        emit({"phase": "main_path", "model": "S", "precision": precision,
              "height": H, "width": W, "requests": len(pairs), "ms_per_frame": ms,
              "median_ms": med, "fps": 1e3 / med, "max_memory_allocated": peak,
              "launches": counts,
              "benchmark": eng.benchmark(H, W, n_warmup=1, n_iter=5)})
        del eng
        torch.cuda.empty_cache()
    return launches, medians, disps


def phase_xl(pairs, medians):
    """XL at 1216x1024: bf16 fused, bf16 unfused on the same weights, fp32
    fused; returns the launches of the three runs together and the bf16
    unfused disparities, and adds each run's median ms to `medians`."""
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
        med = medians[label] = float(np.median(ms))
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


def conv_models():
    """(label, configuration) of each float32 forward `phase_conv` holds G
    to: S2M2 S and XL, RAFT-Stereo at the published defaults."""
    from s2m2_torch.config import RaftStereoConfig, get_config
    return (("S", get_config("S")), ("XL", get_config("XL")), ("RAFT", RaftStereoConfig()))


def conv_shapes(cfg, h, w):
    """Counter of the (b, c, h, w, n, kh, kw, ph, pw) shapes kernel G takes
    (`ops.conv.plan`) in one batch-1 float32 forward at (h, w) of the model
    `cfg` names (S2M2 or RAFT-Stereo): the model run on meta tensors with
    its Conv.forward recorded."""
    import torch
    from s2m2_torch.models import layers
    from s2m2_torch.models.raft_stereo import RAFTStereo
    from s2m2_torch.models.s2m2 import S2M2
    from s2m2_torch.ops import conv
    shapes = Counter()
    forward = layers.Conv.forward

    def record(mod, x, haloed=False):
        b, c, hh, ww = x.shape
        n, _, kh, kw = mod.weight.shape
        shape = (b, c, hh, ww, n, kh, kw, *mod.pads())
        if mod.stride == 1 and conv.plan(shape) is not None:
            shapes[shape] += 1
        return forward(mod, x, haloed)

    layers.Conv.forward = record
    try:
        with torch.device("meta"), torch.no_grad():
            model = {"s2m2": S2M2, "raft_stereo": RAFTStereo}[cfg.architecture](cfg)
            model(torch.empty(1, h, w, 3), torch.empty(1, h, w, 3))
    finally:
        layers.Conv.forward = forward
    return shapes


def phase_conv():
    """Kernel G at every shape an S, an XL and a RAFT-Stereo float32
    forward give it: its error and its plain version's against float64, its
    time in turns with cuDNN's float32 conv, the sums over a forward, the
    spatial shapes (`conv`, `conv_forward`) apart from the 1x1 ones of G's
    flat path (`conv1x1`, `conv1x1_forward`); then the launches of one S,
    one XL and one RAFT-Stereo float32 forward under each launch count."""
    import torch
    import torch.nn.functional as F
    from s2m2_torch.ops import _build, conv
    from s2m2_torch.runtime.engine import StereoEngine

    bound_err = 1e-5
    models = dict(conv_models())
    for model, cfg in models.items():
        shapes = conv_shapes(cfg, H, W)
        tot = {"conv_tf32x3": Counter(), "conv1x1_tf32x3": Counter()}
        for shape, per_forward in sorted(shapes.items()):
            b, c, h, w, n, kh, kw, ph, pw = shape
            key = _conv_launch_key(shape)
            g = torch.Generator(device="cuda").manual_seed(0)
            x = torch.randn(b, c, h, w, device="cuda", generator=g)
            wt = (torch.rand(n, c, kh, kw, device="cuda", generator=g) * 2 - 1) \
                * (2.0 / (c * kh * kw)) ** 0.5
            bias = torch.randn(n, device="cuda", generator=g) * 0.1
            ws = conv.split_weight(wt)
            y64 = F.conv2d(x.double(), wt.double(), bias.double(), padding=(ph, pw))
            scale = y64.abs().max().item()
            before = _build.launch_counts[key]
            y = conv.conv_tf32x3(x, ws, bias, kh, kw, ph, pw)
            yp = conv.conv_tf32x3_plain(x, ws, bias, kh, kw, ph, pw)
            yc = F.conv2d(x, wt, bias, padding=(ph, pw))
            torch.cuda.synchronize()
            if _build.launch_counts[key] != before + 1:
                raise AssertionError(f"G {shape}: not one launch of {key}")
            errs = {k: (t.double() - y64).abs().max().item() / scale
                    for k, t in (("err", y), ("plain_err", yp), ("cudnn_err", yc))}
            del y64, yp, yc
            if not errs["err"] <= bound_err:
                raise AssertionError(f"G {shape}: error {errs['err']:.3g} over {bound_err}")

            def g_call():
                conv.conv_tf32x3(x, ws, bias, kh, kw, ph, pw)

            def cudnn_call():
                F.conv2d(x, wt, bias, padding=(ph, pw))

            abba = [time_ms(f, n=10) for f in (cudnn_call, g_call, g_call, cudnn_call)]
            ho, wo = conv.out_hw(h, w, kh, kw, ph, pw)
            flops = 2 * b * ho * wo * n * c * kh * kw
            nbytes = 4 * (b * c * h * w + n * c * kh * kw + b * n * ho * wo)
            parts = (1e3 * nbytes / PEAK_BYTES, 1e3 * flops / SPLIT_TF32_FLOPS)
            rec = {"ms": (abba[1] + abba[2]) / 2, "library_ms": (abba[0] + abba[3]) / 2,
                   "plain_ms": time_ms(lambda: conv.conv_tf32x3_plain(x, ws, bias, kh, kw,
                                                                      ph, pw), n=3),
                   "bound_ms": max(parts)}
            emit({"phase": "conv" if key == "conv_tf32x3" else "conv1x1", "model": model,
                  "shape": shape, "per_forward": per_forward,
                  "plan": conv.plan(shape)._asdict(), **errs, "abba_ms": abba, **rec,
                  "bound_parts_ms": dict(zip(("bytes", "operations"), parts)),
                  "tflops": flops / rec["ms"] / 1e9})
            for k, v in rec.items():
                tot[key][k] += v * per_forward
            tot[key]["launches_per_forward"] += per_forward
            del x, wt, ws, y
            torch.cuda.empty_cache()
        emit({"phase": "conv_forward", "model": model, **tot["conv_tf32x3"]})
        emit({"phase": "conv1x1_forward", "model": model, **tot["conv1x1_tf32x3"]})
    rng = np.random.default_rng(0)
    left = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    for model in ("S", "XL", "RAFT"):
        eng = StereoEngine(models[model], precision="fp32", seed=0)
        eng.run(left, left)
        before = dict(_build.launch_counts)
        eng.run(left, np.roll(left, -8, axis=1))
        expected = Counter()
        for shape, per_forward in conv_shapes(models[model], H, W).items():
            expected[_conv_launch_key(shape)] += per_forward
        for key in ("conv_tf32x3", "conv1x1_tf32x3"):
            launched = _build.launch_counts[key] - before[key]
            emit({"phase": "conv_launches", "model": model, "kernel": key,
                  "launches": launched, "expected": expected[key]})
            if launched != expected[key]:
                raise AssertionError(f"G launched {launched} times under {key} in a {model} "
                                     f"float32 forward, expected {expected[key]}")
        del eng
        torch.cuda.empty_cache()


def _conv_launch_key(shape):
    """The launch count a conv of `shape` goes to: G's flat path for 1x1."""
    return "conv1x1_tf32x3" if shape[5] == shape[6] == 1 else "conv_tf32x3"


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
           "int8_gemm": sum(r["kind"] == "gemm" for r in log),
           "int8_attention": sum(r["kind"] == "attention" for r in log)}
    if sites != eng.quant_gemms or min(per[k] for k in E_KERNELS) <= 0 or \
            (per["int8_attention"] > 0) != eng.quant_policy["attn"]:
        raise AssertionError(f"{label}: {sites} quantized GEMMs in the forward, "
                             f"{eng.quant_gemms} in calibration; launches {per}")
    wide = [r["in_shape"] for r in log if r["kind"] == "pack" and r["layout"] == "im2col"
            and ig.implicit(r["in_shape"][1])]
    if wide:  # every conv with C >= 32 runs as an implicit GEMM, without im2col rows
        raise AssertionError(f"{label}: explicit im2col packs of wide convs: {wide[:3]}")
    for name, n in per.items():
        if counts[name] != n * n_requests:
            raise AssertionError(f"{label}: {name} launched {counts[name]} times, "
                                 f"expected {n} x {n_requests}")
    return per, log


def phase_int8(shapes, f_shapes, pairs, xl_bf16_disps, s_disps):
    """XL int8 at 1216x1024 (4 requests, profiled), then S int8a and int8r
    (2 requests each), then S int8 alone, with int8_attn and with
    int8_acc_bf16 (8 requests each, their disparities against phase 5's S
    fp32 and bf16 ones, `s_disps`; F's launches a forward from `f_shapes`,
    `int8_attn_shapes`). Returns (launches, the XL forward's site
    log, the XL engine's calibrated scales, which phase 10 exports)."""
    import torch
    from s2m2_torch.runtime.engine import StereoEngine

    launches = Counter()
    s_forward = {k: sum(v.values()) for k, v in shapes.items()}
    # with int8_attn every attention core without PE runs on F, none on A or B
    f_forward = {**s_forward, "scanline_attention": 0, "scanline_cross_attention": 0,
                 "int8_attention": sum(f_shapes.values())}
    runs = [("XL", "int8", pairs[:N_XL_REQUESTS], XL_LAUNCHES[False], {}),
            ("S", "int8a", pairs[:N_INT8_S_REQUESTS], s_forward, {}),
            ("S", "int8r", pairs[:N_INT8_S_REQUESTS], s_forward, {}),
            ("S", "int8", pairs, s_forward, {}),
            ("S", "int8", pairs, f_forward, {"int8_attn": True}),
            ("S", "int8", pairs, s_forward, {"int8_acc_bf16": True})]
    xl_log = xl_scales = None
    for model, precision, run_pairs, per_forward, optins in runs:
        eng = StereoEngine(model, precision=precision, seed=0, **optins)
        t0 = time.perf_counter()
        left, right = run_pairs[0]
        eng._auto_calibrate(left[None], right[None])  # what run() does first
        calib_s = time.perf_counter() - t0
        label = " ".join([model, precision, *optins])
        ms, disps, counts, peak = serve(eng, label, run_pairs, per_forward)
        per, log = _int8_counts(eng, label, counts, len(run_pairs))
        launches.update(counts)
        med = float(np.median(ms))
        rec = {"phase": "int8_path", "model": model, "precision": precision,
               "height": H, "width": W, "requests": len(run_pairs), "ms_per_frame": ms,
               "median_ms": med, "fps": 1e3 / med, "max_memory_allocated": peak,
               "calibration_s": calib_s, "sites": len(eng.quant_scales),
               "quantized_gemms": eng.quant_gemms, "e_launches_per_forward": per,
               "launches": counts, "optins": sorted(optins)}
        if model == "S" and precision == "int8":
            for ref in ("fp32", "bf16"):
                rec[f"mean_abs_disp_diff_vs_{ref}_px"] = float(np.mean(
                    [np.abs(a - b).mean() for a, b in zip(disps, s_disps[ref])]))
        if model == "XL":
            xl_log, xl_scales = log, eng.quant_scales
            delta = [float(np.abs(a - b).mean()) for a, b in zip(disps, xl_bf16_disps)]
            rec["mean_abs_disp_diff_vs_bf16_unfused_px"] = float(np.mean(delta))
            emit({**profile_forward(eng, precision, *run_pairs[0]), "model": model})
        emit(rec)
        del eng
        torch.cuda.empty_cache()
    return launches, xl_log, xl_scales


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
    from s2m2_torch.demo._scenes import synthetic_calibration
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


def _train_shapes(cfg, h, w, batch):
    """main_path_shapes at `batch` pairs: every first dim scales with it."""
    return {name: Counter({(s[0] * batch, *s[1:]): n for s, n in counter.items()})
            for name, counter in main_path_shapes(cfg, h, w).items()}


def _vjp(fn, inputs, cots):
    import torch
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return outs, torch.autograd.grad(outs, leaves, cots)


def phase_grad_wiring():
    """9.1: A, B and C with grad enabled at the shapes an S training step at
    TRAIN_BATCH x 384x512 gives them, float32 and bf16: one launch each
    through the autograd Function, and gradients equal to autograd through
    the plain version on the same inputs and cotangents (the backward
    recomputes it: float rounding, expected 0); D and E raise under grad."""
    import torch
    from s2m2_torch.config import get_config
    from s2m2_torch.models.attention import BasicAttnBlock
    from s2m2_torch.models.layers import layer_norm
    from s2m2_torch.ops import _build
    from s2m2_torch.ops import flash_attention as fa
    from s2m2_torch.ops import fused_block as fb
    from s2m2_torch.ops import int8_gemm as ig
    from s2m2_torch.ops import sinkhorn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    fns = {"scanline_attention": (fa.scanline_attention, fa.scanline_attention_plain),
           "scanline_cross_attention": (fa.scanline_cross_attention_packed,
                                        fa.packed_cross_attention_plain),
           "fused_correlation_ot": (sinkhorn.fused_correlation_ot,
                                    sinkhorn.fused_correlation_ot_plain)}
    shapes = _train_shapes(get_config("S"), TRAIN_H, TRAIN_W, TRAIN_BATCH)
    failures = []
    for name, (fn, plain) in fns.items():
        for shape in shapes[name]:
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[1]
                if name == "fused_correlation_ot":
                    xs = [layer_norm(torch.randn(shape, generator=g, device=dev)).to(dtype)
                          for _ in range(2)]
                    out_shape = (*shape[:3], shape[2])
                    cots = tuple(torch.randn(out_shape, generator=g, device=dev).to(dtype)
                                 for _ in range(2))
                else:  # B as the model calls it, on the packed (x | y) batch
                    b = shape[0] * (2 if name == "scanline_cross_attention" else 1)
                    xs = [torch.randn((b, *shape[1:]), generator=g, device=dev).to(dtype)
                          for _ in range(3)]
                    cots = (torch.randn((b, *shape[1:]), generator=g, device=dev).to(dtype),)
                _build.reset_launch_counts()
                outs, grads = _vjp(fn, xs, cots)
                torch.cuda.synchronize()
                launched = dict(_build.launch_counts)
                want_outs, want = _vjp(plain, xs, cots)
                grad_err = max(float((a.float() - w.float()).abs().max()) for a, w in
                               zip(grads, want))
                scale = max(float(w.float().abs().max()) for w in want)
                kinds = ("prob", "cv") if len(outs) == 2 else ("attn",)
                fwd = [_max_err_ok(a, w, dn, kind)
                       for a, w, kind in zip(outs, want_outs, kinds)]
                ok = (launched[name] == 1 and sum(launched.values()) == 1
                      and grad_err <= 1e-6 * scale and all(f[2] for f in fwd)
                      and outs[0].grad_fn is not None)
                emit({"phase": "grad_wiring", "kernel": name, "shape": list(shape),
                      "dtype": dn, "launches": launched[name], "grad_max_abs_err": grad_err,
                      "grad_bound": f"<= 1e-6*max|g| = {1e-6 * scale:.3e}",
                      "forward": [{"max_abs_err": e, "bound": bnd} for e, bnd, _ in fwd],
                      "ok": ok})
                if not ok:
                    failures.append((name, shape, dn, grad_err, launched[name]))
    # D and E: no backward, so a call autograd would record raises
    refused = {}
    blk = BasicAttnBlock(64, 2).to(dev)
    rows = torch.randn((8, 32, 64), generator=g, device=dev)
    x = torch.randn((64, 64), generator=g, device=dev, requires_grad=True)
    for label, call in (("fused_basic_attn_block", lambda: fb.fused_basic_attn_block(
                            rows, 4, blk.fused_weights(), 2)),
                        ("int8_quantize_pack", lambda: ig.quantize_pack(x, 10.0)),
                        ("bf16_gemm", lambda: ig.bf16_gemm(x.bfloat16(),
                                                           x.detach().bfloat16()))):
        try:
            call()
            refused[label] = False
        except RuntimeError as err:
            refused[label] = "no backward" in str(err)
    emit({"phase": "grad_wiring", "refused_under_grad": refused})
    if failures or not all(refused.values()):
        raise AssertionError(f"gradient wiring: {failures}, refused {refused}")


def _seeded_model(cfg, device, seed=0):
    from s2m2_torch.models.init import init_params
    from s2m2_torch.models.s2m2 import S2M2
    model = S2M2(cfg)
    model.load_state_dict(init_params(cfg, seed=seed))
    return model.to(device)


def phase_card_vs_cpu():
    """9.2: one fp32 step of CH32/NTR1/refine_iter=2 at 96x128, batch 2
    (TF32 off), from the same seeded weights and batch on the card and on
    the CPU: loss within 1e-4 relative, every gradient leaf within 1e-3 x
    its max |g| on the CPU, no leaf non-zero on the CPU and zero or
    non-finite on the card (a silent gradient stop), and the parameters
    after the step (lr 1e-3) within 1e-5 plus what the gradients' own
    difference explains (2 lr |dg| / |g|: Adam's first update is g / (|g|
    + eps)). A leaf's bound has a floor of 1e-9: at initialisation the
    MRT's q and k gradients are differences of nearly equal terms (a near
    uniform softmax), 4e-11 to 6e-8 at most, and their float32 rounding
    differs between the card and the CPU by up to 5.5e-11 (0.3% of such a
    leaf's max, measured on an H100)."""
    import torch
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.ops import _build
    from s2m2_torch.train import step as tstep
    from s2m2_torch.train.data import synthetic_stereo_batches

    cfg = ModelConfig(feature_channels=32, num_transformer=1, refine_iter=2)
    batch = next(synthetic_stereo_batches(batch=2, height=96, width=128, max_disp=24,
                                          seed=0, n_batches=1))
    res = {}
    lr = 1e-3
    for dev in ("cuda", "cpu"):
        model = _seeded_model(cfg, dev)
        params = dict(model.named_parameters())
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        metrics, grads = tstep.value_and_grad(tstep.make_loss_fn(model), params,
                                              tstep.as_batch(batch, dev))
        opt = tstep.make_optimizer(lr=lr)
        opt.init(params)
        opt.update(params, grads)
        if dev == "cuda":
            torch.cuda.synchronize()
        res[dev] = (float(metrics["loss"]), {k: v.float().cpu() for k, v in grads.items()},
                    {k: v.detach().cpu() for k, v in params.items()},
                    dict(_build.launch_counts), time.perf_counter() - t0)
    loss_c, g_c, p_c, counts, sec_c = res["cuda"]
    loss_h, g_h, p_h, _, sec_h = res["cpu"]
    worst, stopped, param_bad = [], [], []
    for k, gh in g_h.items():
        gc = g_c[k]
        scale = float(gh.abs().max())
        err = float((gc - gh).abs().max())
        worst.append((err / max(scale, 1e-30), k, err, scale))
        if scale > 0 and (not torch.isfinite(gc).all() or float(gc.abs().max()) == 0):
            stopped.append(k)
        tol = 1e-5 + 2 * lr * (gc - gh).abs() / gh.abs().clamp(min=1e-30)
        if not ((p_c[k] - p_h[k]).abs() <= tol).all():
            param_bad.append(k)
    worst.sort(reverse=True)
    bad = [w for w in worst if w[2] > 1e-3 * w[3] + 1e-9]
    loss_ok = abs(loss_c - loss_h) <= 1e-4 * abs(loss_h)
    per_forward = {k: sum(v.values()) for k, v in main_path_shapes(cfg, 96, 128).items()}
    ok = loss_ok and not bad and not stopped and not param_bad and \
        all(counts[k] == n for k, n in per_forward.items())
    emit({"phase": "train_card_vs_cpu", "config": "CH32 NTR1 refine_iter=2, 96x128, batch 2,"
          " fp32, TF32 off", "loss_card": loss_c, "loss_cpu": loss_h,
          "leaves": len(g_h), "worst_leaves": [(k, r, e) for r, k, e, _ in worst[:6]],
          "leaves_over_bound": [k for _, k, _, _ in bad], "silent_stops": stopped,
          "params_off": param_bad, "launches": counts, "card_s": sec_c, "cpu_s": sec_h,
          "ok": ok})
    if not ok:
        raise AssertionError("card and CPU training steps disagree")


def _event_batches(batches, events):
    """Yield `batches`, recording a CUDA event before each: events i and i+1
    bracket the step that consumes batch i."""
    import torch
    for b in batches:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)
        yield b


def _train_run(cfg, batches, steps, label, ckpt=None):
    """train() on the card in bf16 over fp32 masters, its launch counts set
    to 0 just before and read just after; returns (model, optimizer,
    history, per-step ms by CUDA events, peak bytes, counts)."""
    import torch
    from s2m2_torch.ops import _build
    from s2m2_torch.train.trainer import train
    events = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    model, opt, hist = train(cfg, _event_batches(batches, events), num_steps=steps,
                             lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, seed=0,
                             compute_dtype=torch.bfloat16, log_every=1, log=lambda *a: None,
                             checkpoint_dir=ckpt, checkpoint_every=10 ** 6, device="cuda")
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])][:steps]
    losses = [h["loss"] for h in hist]
    want = {k: steps * sum(v.values())
            for k, v in main_path_shapes(cfg, TRAIN_H, TRAIN_W).items()}
    off = {k: counts[k] for k in ("int8_quantize_pack", "int8_gemm", "bf16_gemm")}
    ok = (len(hist) == steps and all(np.isfinite(losses))
          and all(counts[k] == n for k, n in want.items()) and not any(off.values()))
    emit({"phase": "train", "model": label, "batch": batches[0]["img0"].shape[0],
          "height": TRAIN_H, "width": TRAIN_W, "steps": steps,
          "compute_dtype": "bfloat16 over float32 masters", "lr": TRAIN_LR,
          "warmup_steps": TRAIN_WARMUP, "ms_per_step": ms,
          "median_ms_from_step_3": float(np.median(ms[2:])) if steps > 2 else None,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
          "launches": counts, "launches_per_step": {k: counts[k] / steps for k in want},
          "ok": ok})
    if not ok:
        raise AssertionError(f"{label} training: losses {losses}, launches {counts}")
    return model, opt, counts


def _profile_train_step(model, batch):
    """One bf16 training step's forward (loss included) and backward, each
    under torch.profiler: device ms by kernel family, and the backward's
    device ms in the autograd nodes of A, B and C (their plain recompute)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from s2m2_torch.train import step as tstep
    loss_fn = tstep.make_loss_fn(model, torch.bfloat16)
    params = dict(model.named_parameters())
    b = tstep.as_batch(batch, "cuda")
    out = {}
    total = None
    for part in ("forward", "backward"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if part == "forward":
                total, _ = loss_fn(params, b)
            else:
                torch.autograd.grad(total, list(params.values()))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        fams, recompute = Counter(), Counter()
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                fams[_family(evt.key)] += evt.self_device_time_total / 1e3
            for node in ("ScanlineAttentionBackward", "ScanlineCrossAttentionBackward",
                         "FusedCorrelationOTBackward"):
                if evt.key == node:
                    recompute[node] += evt.device_time_total / 1e3
        busy = sum(fams.values())
        out[part] = {"wall_ms": wall, "device_busy_ms": busy if busy > 0 else "not measured",
                     "families_ms": dict(fams.most_common())}
        if part == "backward":
            rec = sum(recompute.values())
            out[part]["recompute_ms"] = dict(recompute) if rec > 0 else "not measured"
            out[part]["recompute_share"] = rec / busy if rec > 0 and busy > 0 \
                else "not measured"
    emit({"phase": "train_profile", "model": "S", "compute_dtype": "bfloat16", **out})


def _resume_check(cfg, model, opt, ckpt, batch):
    """9.5: the checkpoint written after the last step restored into a
    fresh model and optimizer; one more step from both on the same batch,
    with deterministic algorithms on: the parameters must be bitwise
    equal. Returns the launches of the two steps."""
    import torch
    from s2m2_torch.ops import _build
    from s2m2_torch.tools.checkpoint import latest_step, restore_checkpoint
    from s2m2_torch.train import step as tstep
    step = latest_step(ckpt)
    params, opt_state, meta = restore_checkpoint(ckpt, with_opt_state=True, with_meta=True)
    fresh = _seeded_model(cfg, "cuda", seed=1)  # other weights until the restore
    fresh.load_state_dict(params)
    fresh_opt = tstep.make_optimizer(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                                     total_steps=TRAIN_STEPS)
    fresh_step = tstep.make_train_step(cfg, fresh, fresh_opt, torch.bfloat16)
    fresh_opt.load_state_dict(opt_state)
    live_step = tstep.make_train_step(cfg, model, opt, torch.bfloat16)
    flags = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    _build.reset_launch_counts()
    try:
        loss_live = float(live_step(batch)["loss"])
        loss_fresh = float(fresh_step(batch)["loss"])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.use_deterministic_algorithms(flags[1])
        if flags[2] is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = flags[2]
    counts = dict(_build.launch_counts)
    live, other = model.state_dict(), fresh.state_dict()
    differ = [k for k in live if not torch.equal(live[k], other[k])]
    moments = [k for key in ("mu", "nu") for k in opt.state[key]
               if not torch.equal(opt.state[key][k], fresh_opt.state[key][k])]
    ok = not differ and not moments and opt.state["count"] == fresh_opt.state["count"] \
        and meta == {"step": step} and step == TRAIN_STEPS
    emit({"phase": "checkpoint_resume", "restored_step": step, "loss_live": loss_live,
          "loss_restored": loss_fresh, "params": len(live), "params_differing": differ[:10],
          "moments_differing": moments[:10], "count": opt.state["count"],
          "launches": counts, "ok": ok})
    if not ok:
        raise AssertionError(f"resumed step differs: {differ[:5]} {moments[:5]}")
    return counts


def phase_offline_calibration(pair):
    """9.6: tools/calibrate.py for S int8 on its default (the engine's
    benchmark pair) writes the .npy; a fresh engine that loads it and an
    engine that calibrates itself on the same pair give the same scales and,
    on phase 5's first pair, the same disparity. Returns the launches."""
    import tempfile
    import torch
    from s2m2_torch.ops import _build
    from s2m2_torch.runtime.engine import StereoEngine
    from s2m2_torch.tools import calibrate
    _build.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "s_int8_calib.npy")
        t0 = time.perf_counter()
        calibrate.main(["--model", "S", "--out", path])
        cli_s = time.perf_counter() - t0
        loaded = StereoEngine("S", precision="int8", seed=0)
        scales = loaded.load_calibration(path)
    itself = StereoEngine("S", precision="int8", seed=0)
    own = calibrate.calibrate_engine(itself, [tuple(x[0] for x in
                                                    itself._benchmark_calib_pair())])
    d_loaded, d_itself = loaded.run(*pair)[0], itself.run(*pair)[0]
    counts = dict(_build.launch_counts)
    diff = float(np.abs(d_loaded - d_itself).max())
    ok = bool(np.array_equal(scales, own)) and diff == 0.0 and \
        np.isfinite(d_loaded).all() and counts["int8_gemm"] > 0
    emit({"phase": "offline_calibration", "model": "S", "precision": "int8",
          "sites": len(scales), "cli_seconds": cli_s,
          "scales_equal": bool(np.array_equal(scales, own)),
          "max_abs_disp_diff_px": diff, "launches": counts, "ok": ok})
    del loaded, itself
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"calibration cache differs from self-calibration by {diff} px")
    return counts


def phase_train(pair):
    """Phase 9: training on the card (see the module docstring). Returns the
    launches of its main-path runs (training, resume, calibration)."""
    import tempfile
    import torch
    from s2m2_torch.config import get_config
    from s2m2_torch.train.augment import augment_batches
    from s2m2_torch.train.data import synthetic_stereo_batches

    t0 = time.perf_counter()
    phase_grad_wiring()
    phase_card_vs_cpu()
    launches = Counter()
    cfg = get_config("S")
    batches = list(augment_batches(synthetic_stereo_batches(
        batch=TRAIN_BATCH, height=TRAIN_H, width=TRAIN_W, max_disp=64, seed=0,
        n_batches=TRAIN_STEPS + 1), seed=0))
    with tempfile.TemporaryDirectory() as ckpt:
        model, opt, counts = _train_run(cfg, batches, TRAIN_STEPS, "S", ckpt)
        launches.update(counts)
        launches.update(_resume_check(cfg, model, opt, ckpt, batches[TRAIN_STEPS]))
    _profile_train_step(model, batches[TRAIN_STEPS])
    del model, opt
    torch.cuda.empty_cache()
    xl_batches = [{k: v[:1] for k, v in b.items()} for b in batches[:XL_TRAIN_STEPS + 1]]
    model, opt, counts = _train_run(get_config("XL"), xl_batches, XL_TRAIN_STEPS, "XL")
    launches.update(counts)
    del model, opt
    torch.cuda.empty_cache()
    launches.update(phase_offline_calibration(pair))
    emit({"phase": "train_done", "seconds": time.perf_counter() - t0})
    return launches


# phase 10: requests each program serves at 1216x1024, and the bound on its
# disparity against the live model with the same casts (the same kernels
# run in the same order, so 0.0 is expected)
N_EXPORT_REQUESTS = {"S": N_REQUESTS, "XL": N_XL_REQUESTS}
EXPORT_DISP_BOUND = 1e-3
NOT_LAUNCHED = {"fused_basic_attn_block": 0, "int8_quantize_pack": 0, "int8_gemm": 0,
                "int8_attention": 0}


def _synced_ms(fn, *args):
    """(fn(*args), host ms of the call ending in a device synchronize)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _same_casts(model, dtype):
    """The live model as the exported program runs it: float32 NHWC images
    cast to `dtype`, float32 outputs."""
    import torch

    def live(a, b):
        with torch.inference_mode():
            return tuple(o.float() for o in model(a.to(dtype), b.to(dtype)))
    return live


def _serve_artifact(label, model, blob, export_s, tmp, live, state, per_call, pairs):
    """Save `blob`, load it on the card, check one call's launch counts
    against `per_call` (A-E; a plain version inlined into the program would
    show as a missing launch), then serve `pairs` through the program and
    through `live` in turns, with the counts set to 0 just before and read
    just after. Emits one line; returns (the artifact's path, the launches
    of the requests)."""
    import torch
    from s2m2_torch.ops import _build
    from s2m2_torch.tools.export import load_artifact, save_artifact
    path = os.path.join(tmp, f"{label.replace(' ', '_')}.pt2")
    t0 = time.perf_counter()
    save_artifact(path, blob)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn = load_artifact(path)
    load_s = time.perf_counter() - t0
    extra = () if state is None else (state,)
    imgs = [tuple(torch.from_numpy(x[None]).cuda() for x in pair) for pair in pairs]
    fn(*extra, *imgs[0])
    live(*imgs[0])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    fn(*extra, *imgs[0])
    torch.cuda.synchronize()
    counts = {k: _build.launch_counts[k] for k in (*REPLACES,)}
    want = {**NOT_LAUNCHED, **per_call}
    if counts != want:
        raise AssertionError(f"export {label}: launches per call {counts}, expected {want}")
    _build.reset_launch_counts()
    art_ms, live_ms, diffs = [], [], []
    for a, b in imgs:
        got, t = _synced_ms(fn, *extra, a, b)
        art_ms.append(t)
        ref, t = _synced_ms(live, a, b)
        live_ms.append(t)
        for out in got:
            if out.shape != (1, H, W, 1) or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"export {label}: output not finite (1, H, W, 1)")
        diffs.append(float((got[0] - ref[0]).abs().max()))
    launches = dict(_build.launch_counts)
    err = max(diffs)
    emit({"phase": "export", "artifact": label, "model": model, "height": H, "width": W,
          "export_s": export_s, "save_s": save_s, "load_s": load_s,
          "file_mb": len(blob) / 1e6, "weights_in_file": state is None,
          "max_abs_disp_diff_vs_live_px": err, "per_request": diffs,
          "bound_px": EXPORT_DISP_BOUND, "requests": len(imgs), "artifact_ms": art_ms,
          "live_ms": live_ms, "artifact_median_ms": float(np.median(art_ms)),
          "live_median_ms": float(np.median(live_ms)), "launches_per_call": counts,
          "launches": launches})
    if not err <= EXPORT_DISP_BOUND:
        raise AssertionError(f"export {label}: max |disp - live| {err} px above "
                             f"{EXPORT_DISP_BOUND}")
    return path, launches


def _start_load_in_subprocess(path):
    """Start loading and running the artifact at `path` in a fresh process
    that imports only s2m2_torch.tools.export (`_finish_load_in_subprocess`
    waits for it and fails if it loaded any model source)."""
    code = ("import json, sys, torch\n"
            "from s2m2_torch.tools.export import load_artifact\n"
            f"fn = load_artifact({path!r})\n"
            f"x = torch.zeros((1, {H}, {W}, 3), device='cuda')\n"
            "d = fn(x, x)[0]\n"
            "torch.cuda.synchronize()\n"
            "src = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 's2m2_tpu')"
            " or m.startswith('s2m2_torch.models'))\n"
            "print(json.dumps({'shape': list(d.shape), 'finite': bool(torch.isfinite(d)"
            ".all()), 'model_source': src}))\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(ROOT)})
    return proc, time.perf_counter()


def _finish_load_in_subprocess(started):
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"export: loading in a subprocess failed:\n{err[-3000:]}")
    rec = json.loads(out.strip().splitlines()[-1])
    emit({"phase": "export_load_subprocess", "seconds": time.perf_counter() - t0, **rec})
    if rec["shape"] != [1, H, W, 1] or not rec["finite"] or rec["model_source"]:
        raise AssertionError(f"export: the subprocess load gave {rec}")


def phase_export(shapes, pairs, xl_int8_scales):
    """Phase 10: .pt2 programs exported on the card, saved, loaded and
    served (see the module docstring). Returns the launches of their
    requests and of the live models' beside them."""
    import tempfile
    import torch
    from s2m2_torch.config import get_config
    from s2m2_torch.models import quant
    from s2m2_torch.models.init import init_params
    from s2m2_torch.models.s2m2 import S2M2
    from s2m2_torch.runtime.engine import StereoEngine
    from s2m2_torch.tools import export as ex

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    launches = Counter()
    s_call = {k: sum(v.values()) for k, v in shapes.items()}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) S bf16, weights embedded (every parameter cast to bf16)
        cfg = get_config("S")
        state = init_params(cfg, seed=0)
        t0 = time.perf_counter()
        blob = ex.export_forward(state, cfg, H, W, compute_dtype=bf16)
        export_s = time.perf_counter() - t0
        model = S2M2(cfg)
        model.load_state_dict(state)
        model = model.to("cuda", bf16).eval()
        s_path, n = _serve_artifact("S bf16", "S", blob, export_s, tmp,
                                    _same_casts(model, bf16), None, s_call,
                                    pairs[:N_EXPORT_REQUESTS["S"]])
        launches.update(n)
        del model, blob
        # the subprocess loads (a) while (b) is exported on this process's
        # host thread; it ends before (b)'s requests are timed
        sub = _start_load_in_subprocess(s_path)
        try:
            # (b) XL bf16, fused block, weight-free: the state is an argument
            cfg = get_config("XL")
            t0 = time.perf_counter()
            blob = ex.export_forward_with_weights(cfg, H, W, compute_dtype=bf16,
                                                  fused_block=True)
            export_s = time.perf_counter() - t0
            model = S2M2(cfg, fused_block=True)
            model.load_state_dict(init_params(cfg, seed=0))
            model = model.to("cuda", bf16).eval()
        except BaseException:
            sub[0].kill()
            sub[0].wait()
            raise
        _finish_load_in_subprocess(sub)
        _, n = _serve_artifact("XL bf16 fused weight-free", "XL", blob, export_s, tmp,
                               _same_casts(model, bf16), model.state_dict(),
                               XL_LAUNCHES[True], pairs[:N_EXPORT_REQUESTS["XL"]])
        launches.update(n)
        del model, blob
        torch.cuda.empty_cache()

        # (c) XL int8: phase 7's calibration (its scales) on phase 7's engine
        eng = StereoEngine("XL", precision="int8", seed=0)
        np.save(os.path.join(tmp, "xl_int8.npy"), xl_int8_scales)
        eng.load_calibration(os.path.join(tmp, "xl_int8.npy"))
        live = _same_casts(eng._forward, eng.compute_dtype)
        live(*(torch.from_numpy(x[None]).cuda() for x in pairs[0]))
        log = quant.last_log()
        int8_call = {**XL_LAUNCHES[False],
                     "int8_quantize_pack": sum(r["kind"] == "pack" for r in log),
                     "int8_gemm": sum(r["kind"] == "gemm" for r in log)}
        t0 = time.perf_counter()
        blob = ex.export_quantized_forward(eng, H, W)
        export_s = time.perf_counter() - t0
        _, n = _serve_artifact("XL int8", "XL", blob, export_s, tmp, live,
                               ex.quantized_state(eng), int8_call,
                               pairs[:N_EXPORT_REQUESTS["XL"]])
        launches.update(n)
        del eng, blob
        torch.cuda.empty_cache()
    emit({"phase": "export_done", "seconds": time.perf_counter() - t_phase})
    return launches


# phase 11: the user's entry points, each in its own process as a user runs
# it. The convergence run takes 300 steps (600 take about 190 s on an H100
# at ~290 ms a step); its final held-out EPE bound is a full 300-step bf16
# run's on an H100 (0.891 px, PERF.md section 6) plus 0.15 px, its bad-2.0
# bound the 600-step target's
CONVERGENCE_STEPS = 300
CONVERGENCE_EPE, CONVERGENCE_BAD2 = 0.891 + 0.15, 0.15
ABC = ("scanline_attention", "scanline_cross_attention", "fused_correlation_ot")
G_KERNELS = ("conv_tf32x3", "conv1x1_tf32x3")  # G's spatial and flat launch counts
FORBIDDEN_MODULES = ("cv2", "PIL", "jax", "s2m2_tpu")


def wrap_cli(module, argv):
    """`chip_smoke.py --cli MODULE ARGS...`: run `python -m MODULE ARGS` in
    this process with every forward of the port's model counted, then print,
    as the last line, one JSON object: the exit code, wall seconds, the
    forwards, the kernels' launch counts and the loaded modules of
    FORBIDDEN_MODULES. Returns the module's exit code."""
    import runpy
    sys.path.insert(0, str(ROOT))
    from s2m2_torch.models.s2m2 import S2M2
    from s2m2_torch.ops import _build
    forwards = [0]
    forward = S2M2.forward

    def counted(self, *args, **kwargs):
        forwards[0] += 1
        return forward(self, *args, **kwargs)

    S2M2.forward = counted
    sys.argv = [module, *argv]
    t0 = time.perf_counter()
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
        rc = 0
    except SystemExit as exc:
        rc = exc.code if isinstance(exc.code, int) else int(exc.code is not None)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)
    print(json.dumps({"module": module, "rc": rc, "wall_s": time.perf_counter() - t0,
                      "forwards": forwards[0], "launches": dict(_build.launch_counts),
                      "forbidden_modules": loaded}), flush=True)
    return rc


def _run_cli(label, module, argv, per_forward, timeout=600):
    """Run one entry point through `wrap_cli` in a subprocess on the card;
    check its exit code, that it loaded none of FORBIDDEN_MODULES, and that
    A, B and C launched `per_forward` times a forward (D and E never; G,
    which takes a float32 forward's stride-1 convs, is counted a forward).
    Returns (its standard output, the wrapper's record)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--cli", module,
                           *argv], capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=ROOT)
    lines = proc.stdout.strip().splitlines()
    try:
        rec = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        raise AssertionError(f"{label}: no wrapper record (rc {proc.returncode}): "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}") from None
    counts = rec["launches"]
    n = rec["forwards"]
    per = {k: counts[k] / n if n else None for k in (*ABC, *G_KERNELS)}
    bad = [k for k in ABC if counts[k] != per_forward[k] * n or n == 0]
    bad += [k for k, v in counts.items() if k not in ABC and k not in G_KERNELS and v]
    if rec["rc"] != 0 or rec["forbidden_modules"] or bad:
        raise AssertionError(f"{label}: rc {rec['rc']}, loaded {rec['forbidden_modules']}, "
                             f"launches {counts} over {n} forwards (expected "
                             f"{per_forward} each): {proc.stderr[-2000:]}")
    rec["launches_per_forward"] = per
    rec["process_s"] = time.perf_counter() - t0
    return proc.stdout, rec


def _printed(pattern, text, cast=float):
    """The last match of `pattern`'s group in `text`, cast, or None."""
    found = re.findall(pattern, text)
    return cast(found[-1]) if found else None


def phase_entry_points(medians):
    """Phase 11: the five demo CLIs at their defaults (synthesized inputs),
    then the bf16 convergence run, each in a subprocess through `wrap_cli`.
    Returns the launches of their runs."""
    import tempfile
    from s2m2_torch.config import ModelConfig, get_config
    from s2m2_torch.utils.png import read_png

    def counts(cfg):
        return {k: sum(v.values()) for k, v in main_path_shapes(cfg, H, W).items()}

    t_phase = time.perf_counter()
    per = {"S": counts(get_config("S")), "L": counts(get_config("L")),
           "XL": XL_LAUNCHES[False],
           "tiny": counts(ModelConfig(feature_channels=32, num_transformer=1, refine_iter=1)),
           "convergence": counts(ModelConfig(feature_channels=32, num_transformer=1,
                                             refine_iter=2))}
    launches = Counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = {k: os.path.join(tmp, k) for k in ("2d.png", "middlebury.ply", "booster.ply",
                                                 "convergence.json")}
        runs = (
            ("2d", "visualize_2d_simple", ["--out", out["2d.png"]], "S"),
            ("middlebury", "visualize_3d_middlebury", ["--out", out["middlebury.ply"]], "L"),
            ("booster", "visualize_3d_booster", ["--out", out["booster.ply"]], "XL"),
            ("online_calibration", "online_calibration", ["--method", "cem"], "S"),
            ("train_demo", "train_demo", [], "tiny"),
            ("convergence", None, ["--bf16", "--steps", str(CONVERGENCE_STEPS),
                                   "--eval-every", str(CONVERGENCE_STEPS),
                                   "--out", out["convergence.json"]], "convergence"))
        for label, name, argv, model in runs:
            module = (f"s2m2_torch.demo.{name}" if name
                      else "s2m2_torch.tools.train_convergence")
            stdout, rec = _run_cli(label, module, argv, per[model])
            launches.update(rec["launches"])
            line = {"phase": "entry_point", "cli": label, "module": module, "argv": argv,
                    "model": model, "process_s": rec["process_s"], "wall_s": rec["wall_s"],
                    "forwards": rec["forwards"], "launches": rec["launches"],
                    "launches_per_forward": rec["launches_per_forward"],
                    "ms_printed": _printed(r"runtime:? ([0-9.]+) ms", stdout)}
            problem = None
            if label == "2d":
                panel = read_png(out["2d.png"])
                line.update(panel_bytes=os.path.getsize(out["2d.png"]),
                            panel_shape=list(panel.shape),
                            phase5_S_bf16_median_ms=medians["S bf16"])
                if panel.shape != (H, 3 * W, 3):
                    problem = f"panel {panel.shape}"
            elif label in ("middlebury", "booster"):
                line["ply_points"] = _printed(r"saved (\d+) points", stdout, int)
                with open(out[f"{label}.ply"], "rb") as f:
                    if f.read(3) != b"ply" or line["ply_points"] is None:
                        problem = "no point cloud"
                if label == "booster":
                    line["phase6_XL_bf16_unfused_median_ms"] = \
                        medians["XL bf16 fused_block=False"]
            elif label == "online_calibration":
                line["final_confidence"] = _printed(r"final_confidence: ([-+0-9.]+)", stdout)
                if line["final_confidence"] is None:
                    problem = "no result printed"
            elif label == "train_demo":
                line["losses"] = [float(x) for x in re.findall(r"loss=(\S+) epe=", stdout)]
                if not line["losses"] or not np.isfinite(line["losses"]).all():
                    problem = f"losses {line['losses']}"
            else:
                with open(out["convergence.json"]) as f:
                    res = json.load(f)["bf16"]
                line.update({k: res[k] for k in (
                    "init_epe", "final_epe", "init_bad2", "final_bad2", "all_losses_finite",
                    "ms_per_step_median", "ms_per_step_mean", "history")})
                line.update(train_wall_s=res["wall_s"], bounds={
                    "final_epe": CONVERGENCE_EPE, "final_bad2": CONVERGENCE_BAD2})
                if not (res["all_losses_finite"] and res["final_epe"] <= CONVERGENCE_EPE
                        and res["final_bad2"] <= CONVERGENCE_BAD2):
                    problem = (f"final EPE {res['final_epe']} px, bad-2.0 {res['final_bad2']}, "
                               f"losses finite {res['all_losses_finite']}")
            line["ok"] = problem is None
            emit(line)
            if problem:
                raise AssertionError(f"entry point {label}: {problem}")
    emit({"phase": "entry_points_done", "seconds": time.perf_counter() - t_phase})
    return launches


# phase 12: multi-device inference and data-parallel training on 2 ranks.
# With one card both ranks share cuda:0 over the host transport (gloo on
# host copies), so the times say nothing about scaling; with two or more
# cards each rank has its own and they talk over NCCL.
PARALLEL_RANKS = 2
PARALLEL_REQUESTS = 3
PARALLEL_TIMEOUT = 400       # seconds for the whole phase's ranks
PARALLEL_GROUP_TIMEOUT = 300  # seconds a collective of a rank may wait
# (label, precision, fused block, mesh (data, band), pairs a request)
PARALLEL_CELLS = (("fp32 1x2", "fp32", False, (1, 2), 1),
                  ("bf16 1x2", "bf16", False, (1, 2), 1),
                  ("bf16 2x1", "bf16", False, (2, 1), 2),
                  ("bf16 fused 1x2", "bf16", True, (1, 2), 1),
                  ("int8 1x2", "int8", False, (1, 2), 1))
PARALLEL_NOTE = "one card shared by 2 ranks, host transport: not a scaling figure"
# outputs against the unsharded engine on the same requests. fp32 disp and
# occ keep their planned bounds. fp32 conf and the bf16 mean disparity
# cannot: the unsharded forward moves them more under a 1e-6 relative input
# change than the planned 1e-4 and 0.01 px, so they are fixed at twice the
# largest such change (5 perturbations over the 3 requests of each
# cell, `s2m2_torch/tools/chip_probe.py sensitivity`, NVIDIA H100 80GB
# HBM3, 700.00 W: fp32 conf 2.50e-3 to 3.37e-3, bf16 mean 0.0127 to 0.0130
# px; PERF.md section 6)
PARALLEL_BOUNDS = {"fp32": {"max_abs_disp_diff_px": 1e-3, "max_abs_occ_diff": 1e-4,
                            "max_abs_conf_diff": 6.8e-3},
                   "bf16": {"mean_abs_disp_diff_px": 0.026}}
PARALLEL_PLANNED = {"max_abs_conf_diff": 1e-4, "mean_abs_disp_diff_px": 0.01}
E_KERNELS = ("int8_quantize_pack", "int8_gemm")


def _batch(pairs):
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _parallel_requests(eng, requests, untimed=contextlib.nullcontext()):
    """Serve `requests` (lists of (left, right) pairs, one batch each) through
    eng.run after one untimed request, made inside the context `untimed`;
    launch counts set to 0 just before the timed ones and read just after.
    Returns (outputs of each request, ms of each, launches per forward, the
    last forward's band collectives and quant log)."""
    from s2m2_torch.models import quant
    from s2m2_torch.ops import _build
    from s2m2_torch.parallel import band

    with untimed:
        eng.run(*_batch(requests[0]))
    _build.reset_launch_counts()
    band.reset_counts()
    outs, ms = [], []
    for pairs in requests:
        disp, occ, conf, _, t = eng.run(*_batch(pairs))
        outs.append((disp, occ, conf))
        ms.append(t)
    counts = dict(_build.launch_counts)
    per = {k: v / len(requests) for k, v in counts.items()}
    return outs, ms, per, counts, band.last_counts(), quant.last_log()


@contextlib.contextmanager
def _abcd_calls(calls):
    """Within: each distinct call the model makes of kernels A-D added to
    the set `calls`, as (kernel, shape as `main_path_shapes` gives it, dtype
    name, kernel C's keywords); the wrappers themselves still run."""
    from s2m2_torch.models import matching
    from s2m2_torch.ops import flash_attention as fa
    from s2m2_torch.ops import fused_block as fb
    dn = lambda t: str(t.dtype).split(".")[1]  # noqa: E731
    keys = {
        (fa, "scanline_attention"):
            lambda q, k, v: ("scanline_attention", tuple(q.shape), dn(q), ()),
        (fa, "scanline_cross_attention_packed"):
            lambda q, k, v: ("scanline_cross_attention", (q.shape[0] // 2, *q.shape[1:]),
                             dn(q), ()),
        (matching, "fused_correlation_ot"):
            lambda f0, f1, **kw: ("fused_correlation_ot", tuple(f0.shape), dn(f0),
                                  tuple(sorted(kw.items()))),
        (fb, "fused_basic_attn_block"):
            lambda rows, right0, weights, heads: ("fused_basic_attn_block",
                                                  (right0, *rows.shape[1:], heads), dn(rows), ()),
    }
    saved = {}
    for (mod, attr), key in keys.items():
        fn = saved[(mod, attr)] = getattr(mod, attr)

        def recorded(*args, _fn=fn, _key=key, **kw):
            calls.add(_key(*args, **kw))
            return _fn(*args, **kw)
        setattr(mod, attr, recorded)
    try:
        yield
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


def _abcd_band_sites(calls, done):
    """Kernels A-D at the shapes a sharded forward gave them (`_abcd_calls`),
    each distinct one not in `done` once through its wrapper and its plain
    version on phase 3's seeded inputs, with phase 3's tolerances. Adds the
    checked ones to `done`; returns their records; raises on a mismatch."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    out, failures = [], []
    for name, shape, dn, kw in sorted(calls - done):
        done.add((name, shape, dn, kw))
        with torch.inference_mode():  # as phase 3
            checks = _kernel_case(name, shape, getattr(torch, dn), g, **dict(kw))[0]
        for kind, a, b in checks:
            err, limit, ok = _max_err_ok(a, b, dn, kind)
            out.append({"kernel": name, "shape": list(shape), "dtype": dn, "output": kind,
                        "max_abs_err": err, "bound": limit, "ok": ok})
            if not ok:
                failures.append(out[-1])
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions at the "
                             f"band-sharded shapes: {failures}")
    return out


def _e_band_sites(log):
    """Kernel E at the band-sharded forward's own conv geometries (row
    padding 0 on rows that carry their halo) against its plain version:
    each distinct pack bit-equal, each GEMM's int32 accumulators bit-equal.
    Returns the shapes checked and how many of the GEMMs loaded their taps
    as TMA boxes (`ig.tap_tiles`: stride 1, Cp % 128 == 0), the route whose
    row and column paddings then differ; raises on a mismatch."""
    import torch
    from s2m2_torch.ops import int8_gemm as ig
    g = torch.Generator(device="cuda").manual_seed(0)
    seen, checked, tiled = set(), 0, 0
    for r in log:
        conv = r.get("conv")
        if r["kind"] not in ("pack", "gemm") or conv is None or conv[4] != 0 or conv[0] == 1:
            continue
        key = (r["kind"], tuple(r.get("in_shape") or r.get("a_shape")), tuple(conv))
        if key in seen:
            continue
        seen.add(key)
        if r["kind"] == "pack":
            if r["layout"] != "im2col":
                continue
            x, kw = _site_pack_inputs(g, r)
            ok = torch.equal(ig.quantize_pack(x, 20.0, **kw),
                             ig.quantize_pack_plain(x, 20.0, **kw))
        else:
            a, w = _site_gemm_inputs(g, r)
            ok = torch.equal(ig.int8_gemm(a, w, out_dtype=torch.int32, conv=conv),
                             ig.int8_gemm_plain(a, w, out_dtype=torch.int32, conv=conv))
            tiled += ig.tap_tiles(conv, r["a_shape"][3])
        checked += 1
        if not ok:
            raise AssertionError(f"kernel E disagrees with its plain version at the "
                                 f"band-sharded {r['kind']} {key}")
    return {"shapes": checked, "tap_tiles_gemms": tiled}


def _parallel_train_check(mesh, lead):
    """Data-parallel training at 2x1: CH32/NTR1/refine_iter 2, batch 2 at
    96x128 (one pair a rank), fp32; the first step's gradient and 3 steps of
    `train()`, and on the lead rank the same in one process on both pairs.
    Bounds: loss within 1e-4 relative, each gradient leaf within 1e-3 of
    its max |g| + 1e-9 (phase 9's rule: at initialisation the MRT's q and k
    gradients are differences of nearly equal terms)."""
    import torch
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.ops import _build
    from s2m2_torch.train import step as tstep
    from s2m2_torch.train.data import synthetic_stereo_batches
    from s2m2_torch.train.trainer import train

    cfg = ModelConfig(feature_channels=32, num_transformer=1, refine_iter=2)
    batches = list(synthetic_stereo_batches(batch=2, height=96, width=128, max_disp=24,
                                            seed=0, n_batches=3))
    dev = mesh.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda _: None)

    def grads(m):
        model = _seeded_model(cfg, dev)
        params = dict(model.named_parameters())
        part = tstep.as_batch(tstep.shard_batch(batches[0], m), dev)
        metrics, g = tstep.value_and_grad(tstep.make_loss_fn(model), params, part, m)
        return float(metrics["loss"]), {k: v.float().cpu() for k, v in g.items()}

    def losses(m):
        sync(dev)
        t0 = time.perf_counter()
        _, _, hist = train(cfg, iter(batches), num_steps=3, lr=1e-4, log_every=1,
                           log=lambda _: None, device=dev, mesh=m)
        sync(dev)
        return [h["loss"] for h in hist], (time.perf_counter() - t0) * 1e3 / 3

    _build.reset_launch_counts()
    loss_dp, g_dp = grads(mesh)
    dp_losses, dp_ms = losses(mesh)
    counts = dict(_build.launch_counts)
    rec = {"cell": "train 2x1", "config": "CH32 NTR1 refine_iter=2, 96x128, batch 2, fp32",
           "loss": loss_dp, "losses": dp_losses, "ms_per_step": dp_ms, "launches": counts}
    if lead:
        loss_1, g_1 = grads(None)
        one_losses, one_ms = losses(None)
        worst = max((float((g_dp[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30), k)
                    for k, g in g_1.items())
        bad = [k for k, g in g_1.items()
               if float((g_dp[k] - g).abs().max()) > 1e-3 * float(g.abs().max()) + 1e-9]
        rec.update(single_loss=loss_1, single_losses=one_losses, single_ms_per_step=one_ms,
                   worst_leaf=worst, leaves_over_bound=bad,
                   loss_rel_err=abs(loss_dp - loss_1) / abs(loss_1),
                   losses_rel_err=max(abs(a - b) / abs(b) for a, b in zip(dp_losses,
                                                                          one_losses)))
        rec["ok"] = rec["loss_rel_err"] <= 1e-4 and rec["losses_rel_err"] <= 1e-4 and not bad
    return rec


# phase 12's band-sharded training step: S at full width, 256x384, batch 2
BAND_TRAIN_H, BAND_TRAIN_W, BAND_TRAIN_BATCH = 256, 384, 2


def _band_grad_checks(got, ref, ctl=None, partials=None):
    """Phase 12's per-leaf rule for the band-sharded step's gradients `got`
    against the unsharded step's `ref` (float32 tensors by name). Without a
    control (fp32): each leaf within 1e-3 of its max |g| + 1e-9, or, a leaf
    whose norm is below 1e-3 of the whole gradient's (differences of nearly
    equal terms at initialisation), within 2e-6 of the whole norm in L2
    (the whole gradient's own error was 6.1e-7 of it on the H100).
    With `ctl`, the unsharded step's gradients under a 1e-6 relative change
    of the input, and `partials`, the sum over ranks of |each rank's
    gradient| (bf16): each leaf's L2 change within four times the control's
    change of the same leaf, plus one bf16 ulp (2^-7) of the partials' L2,
    plus 1e-6 of the whole norm. Each rank's partial gradient is a bf16
    reduction over its band, rounded before the ranks' sum, where the
    unsharded step reduces and rounds once: a leaf whose band partials
    cancel (a bias whose output gradient changes sign between the bands)
    differs by about an ulp of the partials, not of the leaf, and a 1e-6
    input change leaves such a rounding where it was (control 0)."""
    norm = sum(float(v.double().square().sum()) for v in ref.values()) ** 0.5
    bad, near_zero, near_worst, shares = [], [], 0.0, []
    for k, g in ref.items():
        d = (got[k] - g).double()
        d_l2 = float(d.square().sum()) ** 0.5
        if ctl is not None:
            c_l2 = float((ctl[k] - g).double().square().sum()) ** 0.5
            p_l2 = float(partials[k].double().square().sum()) ** 0.5
            limit = 4 * c_l2 + 2 ** -7 * p_l2 + 1e-6 * norm
            shares.append((d_l2 / limit, k, d_l2, c_l2, p_l2))
            if d_l2 > limit:
                bad.append(k)
            continue
        g_l2 = float(g.double().square().sum()) ** 0.5
        limit = 1e-3 * float(g.abs().max()) + 1e-9
        if g_l2 < 1e-3 * norm:
            near_zero.append(k)
            near_worst = max(near_worst, d_l2 / norm)
            if float(d.abs().max()) > limit and d_l2 > 2e-6 * norm:
                bad.append(k)
        else:
            shares.append((float(d.abs().max()) / limit, k))
            if float(d.abs().max()) > limit:
                bad.append(k)
    rec = {"leaves_over_bound": bad, "worst_leaves_share_of_bound": sorted(shares)[-3:]}
    if ctl is None:
        rec.update(near_zero_leaves=len(near_zero), near_zero_worst_l2_of_norm=near_worst)
    return rec


def _band_train_check(mesh, lead):
    """One training step of S over the 1x2 mesh (each rank a band of 128 of
    the 256 rows) in bf16 over fp32 masters, then in fp32, on a synthetic
    batch of 2 at 256x384; on the lead rank the same step unsharded, and,
    as the control of bf16's intrinsic sensitivity, the unsharded bf16 step
    with the left images times 1 + 1e-6. Per rank: the band collectives of
    the step's forward and backward against `band.expected_counts(cfg,
    backward=True)`, and A, B and C's launches against the unsharded step's.
    Bounds on the lead rank (`_band_grad_checks`): fp32 loss within 1e-4
    relative, the whole gradient within 1e-5 relative L2, each gradient leaf
    within 1e-3 of its max |g| + 1e-9 (phase 9's card bound) or, a leaf whose
    norm is below 1e-3 of the whole gradient's, within 2e-6 of the whole
    norm (L2); bf16 loss and whole gradient (relative L2) within the larger
    of (1e-4, 1e-3) and twice the control's change, and each leaf (L2)
    within four times the control's change of that leaf + one bf16 ulp
    (2^-7) of the ranks' summed |partial gradients| of it + 1e-6 of the
    whole norm."""
    import torch
    from s2m2_torch.config import get_config
    from s2m2_torch.ops import _build
    from s2m2_torch.parallel import band
    from s2m2_torch.parallel.mesh import all_reduce
    from s2m2_torch.train.loss import valid_counts
    from s2m2_torch.train import step as tstep
    from s2m2_torch.train.data import synthetic_stereo_batches

    cfg = get_config("S")
    batch = next(synthetic_stereo_batches(batch=BAND_TRAIN_BATCH, height=BAND_TRAIN_H,
                                          width=BAND_TRAIN_W, max_disp=32, seed=0,
                                          n_batches=1))
    dev = mesh.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda _=None: None)

    def step(m, dtype, b):
        model = _seeded_model(cfg, dev)
        params = dict(model.named_parameters())
        part = tstep.as_batch(tstep.shard_batch(b, m), dev)
        band.reset_counts()
        _build.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        metrics, g = tstep.value_and_grad(tstep.make_loss_fn(model, dtype), params, part, m,
                                          tstep.batch_rows(b, m))
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        return {"loss": float(metrics["loss"]), "ms": ms,
                "grads": {k: v.float().cpu() for k, v in g.items()},
                "launches": {k: v for k, v in _build.launch_counts.items() if v},
                "collectives": band.last_counts()["counts"]}

    def partials(m, dtype, b):
        """The sum over ranks of |each rank's own gradient| (float32, by
        name): the step of `tstep.value_and_grad` up to its world-group sum,
        summing magnitudes instead."""
        model = _seeded_model(cfg, dev)
        params = dict(model.named_parameters())
        part = tstep.as_batch(tstep.shard_batch(b, m), dev)
        counts = all_reduce(m, valid_counts(part["valid"]), m.world_group)
        with band.sharded(m, tstep.batch_rows(b, m)):
            total, _ = tstep.make_loss_fn(model, dtype)(params, part, counts)
        grads = torch.autograd.grad(total, list(params.values()))
        flat = all_reduce(m, torch.cat([g.reshape(-1).float().abs() for g in grads]),
                          m.world_group)
        return {k: f.view_as(g).float().cpu()
                for k, f, g in zip(params, flat.split([g.numel() for g in grads]), grads)}

    def rel_l2(a, b):
        num = sum(float((a[k] - b[k]).double().square().sum()) for k in b)
        return (num / sum(float(v.double().square().sum()) for v in b.values())) ** 0.5

    expected = band.expected_counts(cfg, backward=True)
    recs, failed = [], []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        t0 = time.perf_counter()
        got = step(mesh, dtype, batch)
        mags = partials(mesh, dtype, batch) if dtype == torch.bfloat16 else None
        rec = {"phase": "parallel", "cell": f"train band 1x2 {dn}", "mesh": list(mesh.shape),
               "config": f"S, {BAND_TRAIN_H}x{BAND_TRAIN_W}, batch {BAND_TRAIN_BATCH}, "
                         f"{dn} over fp32 masters", "loss": got["loss"],
               "ms_per_step": got["ms"], "launches": got["launches"],
               "collectives_per_step": got["collectives"],
               "collectives_expected": expected}
        problems = [] if got["collectives"] == expected else ["collective counts"]
        if lead:
            ref = step(None, dtype, batch)
            rec.update(single_loss=ref["loss"], single_ms_per_step=ref["ms"],
                       single_launches=ref["launches"],
                       loss_rel_err=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                       grad_rel_l2=rel_l2(got["grads"], ref["grads"]))
            if dev.type == "cuda" and any(got["launches"].get(k, 0) !=
                                          ref["launches"].get(k, 0) or
                                          not got["launches"].get(k) for k in ABC):
                problems.append("A/B/C launches per step")
            ctl = None
            if dtype == torch.bfloat16:
                pert = {**batch, "img0": batch["img0"] * np.float32(1 + 1e-6)}
                ctl = step(None, dtype, pert)
                rec["control_loss_rel"] = abs(ctl["loss"] - ref["loss"]) / abs(ref["loss"])
                rec["control_grad_rel_l2"] = rel_l2(ctl["grads"], ref["grads"])
                ctl = ctl["grads"]
            rec.update(_band_grad_checks(got["grads"], ref["grads"], ctl, mags))
            if dtype == torch.float32:
                rec["bounds"] = {"loss_rel_err": 1e-4, "grad_rel_l2": 1e-5,
                                 "leaf": "1e-3 max|g| + 1e-9, or (a leaf under 1e-3 of the "
                                         "whole norm) 2e-6 of the whole norm"}
            else:
                rec["bounds"] = {"loss_rel_err": max(1e-4, 2 * rec["control_loss_rel"]),
                                 "grad_rel_l2": max(1e-3, 2 * rec["control_grad_rel_l2"]),
                                 "leaf": "4 x the control's change of the leaf + 2^-7 "
                                         "of the ranks' summed |partials| + 1e-6 of the "
                                         "whole norm"}
            ok = rec["loss_rel_err"] <= rec["bounds"]["loss_rel_err"] and \
                rec["grad_rel_l2"] <= rec["bounds"]["grad_rel_l2"] and \
                not rec["leaves_over_bound"]
            if not ok:
                problems.append("loss or gradients against the unsharded step")
        rec["ok"] = not problems
        rec["cell_s"] = time.perf_counter() - t0
        recs.append(rec)
        if problems:
            failed.append((rec["cell"], problems))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return recs, failed


def rank_main(argv):
    """`chip_smoke.py --rank R --world N --init ADDR --backend B [--device
    D]`: one rank of phase 12 (D: cuda:0 under gloo, cuda:R under NCCL, or
    cpu to run its control flow on the CPU). Prints one JSON line per cell;
    exits non-zero when a check of a cell fails."""
    import argparse
    import torch
    sys.path.insert(0, str(ROOT))
    from s2m2_torch.config import get_config
    from s2m2_torch.demo._scenes import stereo_pair
    from s2m2_torch.parallel import band
    from s2m2_torch.parallel.distributed import initialize_distributed
    from s2m2_torch.parallel.mesh import make_mesh
    from s2m2_torch.runtime.engine import StereoEngine

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    initialize_distributed(args.init, args.world, args.rank, backend=args.backend,
                           timeout=PARALLEL_GROUP_TIMEOUT)
    device = args.device or ("cuda:0" if args.backend == "gloo" else f"cuda:{args.rank}")
    on_card = device.startswith("cuda")
    lead = args.rank == 0
    rng = np.random.default_rng(0)
    pairs = [stereo_pair(rng, H, W, 16 + 8 * i) for i in range(2 * PARALLEL_REQUESTS)]
    meshes, failed, abcd_done = {}, [], set()
    expected = band.expected_counts(get_config("S"))
    zeros = dict.fromkeys(band.KINDS, 0)
    for label, precision, fused, shape, per_request in PARALLEL_CELLS:
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device=device, backend=args.backend,
                                      timeout=PARALLEL_GROUP_TIMEOUT)
        mesh = meshes[shape]
        requests = [pairs[per_request * i:per_request * (i + 1)]
                    for i in range(PARALLEL_REQUESTS)]
        t0 = time.perf_counter()
        eng = StereoEngine("S", precision=precision, seed=0, fused_block=fused, mesh=mesh)
        calls = set()
        untimed = _abcd_calls(calls) if lead and on_card else contextlib.nullcontext()
        outs, ms, per, counts, coll, log = _parallel_requests(eng, requests, untimed)
        rec = {"phase": "parallel", "cell": label, "rank": args.rank, "mesh": list(shape),
               "transport": mesh.transport, "device": str(mesh.device), "note": PARALLEL_NOTE,
               "ms_per_request": ms, "median_ms": float(np.median(ms)),
               "launches_per_forward": per, "launches": counts,
               "collectives_per_forward": coll["counts"],
               "collective_bytes_per_forward": coll["bytes"],
               "collectives_expected": expected if shape[1] > 1 else zeros}
        problems = []
        if rec["collectives_per_forward"] != rec["collectives_expected"]:
            problems.append("collective counts")
        if lead and on_card:
            rec["abcd_band_sites_checked"] = _abcd_band_sites(calls, abcd_done)
        if precision.startswith("int8") and lead and on_card:
            rec["e_band_sites_checked"] = _e_band_sites(log)
        del eng
        if lead:  # the unsharded engine on the same requests, in this process
            ref_eng = StereoEngine("S", precision=precision, seed=0, fused_block=fused,
                                   device=device)
            r_outs, r_ms, r_per, _, _, _ = _parallel_requests(ref_eng, requests)
            # the unsharded forward repeats itself to the bit
            again = ref_eng.run(*_batch(requests[0]))[:3]
            rec["unsharded_repeat_max"] = max(float(np.abs(x - r).max())
                                              for x, r in zip(again, r_outs[0]))
            if precision == "int8":
                # the JAX int8 test's control (tests/test_parallel.py:130-137):
                # the unsharded disparity under a 1e-6 relative change of the
                # left image, here over every request
                control = max(float(np.abs(ref_eng.run(a * np.float32(1 + 1e-6), b)[0]
                                           - r[0]).max())
                              for (a, b), r in zip(map(_batch, requests), r_outs))
                rec["perturbation_disp_max"] = control
            del ref_eng
            rec["unsharded_ms_per_request"] = r_ms
            rec["unsharded_median_ms"] = float(np.median(r_ms))
            rec["unsharded_launches_per_forward"] = r_per
            watched = ABC + (("fused_basic_attn_block",) if fused else ()) + \
                (E_KERNELS if precision == "int8" else ()) + \
                (G_KERNELS if precision == "fp32" else ())
            if on_card and (any(per[k] != r_per[k] or per[k] <= 0 for k in watched)
                            or any(per[k] for k in per if k not in watched)):
                problems.append("launches per forward")
            d = [np.abs(o - r) for got, ref in zip(outs, r_outs) for o, r in zip(got, ref)]
            disp_d = np.concatenate([x.ravel() for x in d[0::3]])
            occ_d = np.concatenate([x.ravel() for x in d[1::3]])
            conf_d = np.concatenate([x.ravel() for x in d[2::3]])
            rec.update(max_abs_disp_diff_px=float(disp_d.max()),
                       mean_abs_disp_diff_px=float(disp_d.mean()),
                       max_abs_occ_diff=float(occ_d.max()),
                       max_abs_conf_diff=float(conf_d.max()))
            if precision in PARALLEL_BOUNDS:
                rec["bounds"] = PARALLEL_BOUNDS[precision]
                ok = all(rec[k] <= v for k, v in rec["bounds"].items())
                rec["planned_bounds_met"] = {k: rec[k] <= v for k, v in PARALLEL_PLANNED.items()
                                             if k in rec["bounds"]}
            else:
                bound = max(0.02, 2 * control)
                rec["bounds"] = {"max_abs_diff": bound, "p99_abs_diff": bound / 2}
                every = np.concatenate([disp_d, occ_d, conf_d])
                rec["p99_abs_diff"] = float(np.percentile(every, 99))
                ok = float(every.max()) < bound and rec["p99_abs_diff"] < bound / 2
            if not ok:
                problems.append("outputs against the unsharded engine")
        if on_card:
            torch.cuda.empty_cache()
        torch.distributed.barrier(group=mesh.world_group)
        rec["cell_s"] = time.perf_counter() - t0
        rec["ok"] = not problems
        print(json.dumps(rec), flush=True)
        if problems:
            failed.append((label, problems))
    t0 = time.perf_counter()
    train_rec = _parallel_train_check(meshes[(2, 1)], lead)
    train_rec.update(phase="parallel", rank=args.rank, mesh=[2, 1],
                     transport=meshes[(2, 1)].transport, note=PARALLEL_NOTE,
                     cell_s=time.perf_counter() - t0)
    print(json.dumps(train_rec), flush=True)
    if train_rec.get("ok") is False:
        failed.append(("train 2x1", ["loss or gradients"]))
    band_recs, band_failed = _band_train_check(meshes[(1, 2)], lead)
    for rec in band_recs:
        rec.update(rank=args.rank, transport=meshes[(1, 2)].transport, note=PARALLEL_NOTE)
        print(json.dumps(rec), flush=True)
    failed += band_failed
    torch.distributed.destroy_process_group()
    if failed:
        print(f"rank {args.rank}: failed {failed}", file=sys.stderr)
        return 1
    return 0


def phase_parallel():
    """Phase 12: the port's mesh on 2 ranks started through this script's
    `--rank` mode, both on cuda:0 over gloo (host copies) with one card,
    each on its own card over NCCL with two or more. Returns the launches of
    the ranks' sharded runs."""
    import torch
    from s2m2_torch.parallel.launch import run_ranks
    backend = "nccl" if torch.cuda.device_count() >= PARALLEL_RANKS else "gloo"
    t0 = time.perf_counter()
    outs = run_ranks(lambda rank, init: [sys.executable, str(ROOT / "chip_smoke.py"),
                                         "--rank", str(rank), "--world",
                                         str(PARALLEL_RANKS), "--init", init,
                                         "--backend", backend],
                     PARALLEL_RANKS, timeout=PARALLEL_TIMEOUT, tail=200000,
                     env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS":
                          str(max(1, (os.cpu_count() or 2) // PARALLEL_RANKS))}, cwd=ROOT)
    launches = Counter()
    summary = {}
    for out in outs:
        for line in out.splitlines():
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            emit(rec)
            launches.update(rec["launches"])
            if rec["rank"] == 0:
                summary[rec["cell"]] = {k: rec.get(k) for k in (
                    "median_ms", "unsharded_median_ms", "ms_per_step", "single_ms_per_step",
                    "collectives_per_forward", "collective_bytes_per_forward",
                    "collectives_per_step", "loss_rel_err", "grad_rel_l2")}
    emit({"phase": "parallel_done", "ranks": PARALLEL_RANKS, "backend": backend,
          "transport": "gloo, host copies" if backend == "gloo" else "nccl",
          "cards": torch.cuda.device_count(), "note": PARALLEL_NOTE
          if backend == "gloo" else "one card per rank over NCCL",
          "cells": summary, "seconds": time.perf_counter() - t0})
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
    if "plan" in recs[0] and len(recs) == 1:  # one shape's plan (C's)
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
    comparisons; launches counts every main-path request of phases 5-11 (the
    training steps, the resumed steps and the calibration tool's runs in 9;
    the programs' requests and the live models' beside them in 10; the
    entry points' processes in 11)."""
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
    from s2m2_torch.demo._scenes import stereo_pair

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
    f_shapes = int8_attn_shapes(get_config("S"), H, W)
    xl_blocks = main_path_shapes(get_config("XL"), H, W, fused_block=True)
    with torch.inference_mode():
        xl_unfused = main_path_shapes(get_config("XL"), H, W, fused_block=False)
        results = phase_kernels({**shapes, "fused_basic_attn_block":
                                 xl_blocks["fused_basic_attn_block"],
                                 "int8_attention": f_shapes},
                                {**{k: xl_unfused[k] for k in XL_TIMED if k in xl_unfused},
                                 "int8_attention": int8_attn_shapes(get_config("XL"), H, W)})
        phase_e_acc_bf16()
        phase_probe()
        phase_conv()
    phase_golden(fused_block=False)
    phase_golden(fused_block=True)
    phase_golden_int8()
    rng = np.random.default_rng(0)
    pairs = [stereo_pair(rng, H, W, 16 + 8 * i) for i in range(N_REQUESTS)]
    launches, medians, s_disps = phase_main_path(shapes, pairs)
    xl_launches, xl_bf16_disps = phase_xl(pairs[:N_XL_REQUESTS], medians)
    launches.update(xl_launches)
    int8_launches, xl_int8_log, xl_int8_scales = phase_int8(shapes, f_shapes, pairs,
                                                            xl_bf16_disps, s_disps)
    del s_disps
    launches.update(int8_launches)
    with torch.inference_mode():
        e_entries = phase_int8_sites(xl_int8_log)
    launches.update(phase_calibration(shapes, pairs[0], native_seconds))
    launches.update(phase_train(pairs[0]))
    launches.update(phase_export(shapes, pairs, xl_int8_scales))
    launches.update(phase_entry_points(medians))
    launches.update(phase_parallel())
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
    if sys.argv[1:2] == ["--cli"] and len(sys.argv) > 2:
        sys.exit(wrap_cli(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[1:]))
    sys.exit(main())
