#!/usr/bin/env python3
"""Smoke run of the s2m2_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, `nvcc` and
PyTorch built for CUDA. It imports nothing of JAX or of `s2m2_tpu`. Phases,
each printing one JSON line; any failure raises and the script exits
non-zero:

1. device: the card's name and power limit (nvidia-smi) and the versions;
2. build: compiles `s2m2_torch/csrc/*.cu` (one nvcc each, in parallel) into
   `build/s2m2_torch/`;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the shapes one S 1216x1024 forward gives it, in float32 and
   bfloat16, with times (CUDA events, median of 20) of the kernel, the plain
   version and, for attention, F.scaled_dot_product_attention as a
   yardstick the port never calls;
4. golden: the port on the card, kernels engaged, float32 with TF32 off, on
   every tests/golden/s2m2_*.npz against the reference outputs;
5. main path: StereoEngine("S") in fp32 and bf16 with seeded random weights
   serving 8 requests each on 1216x1024 pairs (the right image is the left
   shifted by a known disparity, plus noise); the kernels' launch counts are
   read around these requests only; then one more forward per precision
   under torch.profiler gives the device time by kernel family.

Then it prints the kernels line, the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}.
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
PEAK_BYTES = 3.35e12       # H100 SXM HBM3, bytes/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # non-tensor fp32; dense bf16
REPLACES = {
    "scanline_attention": "s2m2_tpu/ops/flash_attention.py:58",
    "scanline_cross_attention": "s2m2_tpu/ops/flash_attention.py:101",
    "fused_correlation_ot": "s2m2_tpu/ops/sinkhorn.py:82",
}
SOURCES = {
    "scanline_attention": "s2m2_torch/csrc/scanline_attention.cu",
    "scanline_cross_attention": "s2m2_torch/csrc/scanline_attention.cu",
    "fused_correlation_ot": "s2m2_torch/csrc/sinkhorn_ot.cu",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def main_path_shapes(cfg, h, w):
    """Per kernel, the Counter of input shapes one forward at (h, w) launches
    (batch 1): the MRT's scanline and 2D blocks, the pyramid's non-PE
    bottleneck blocks and the refiners' UNet bottlenecks; cross shapes are
    per view."""
    h4, w4, c, nh, ntr = h // 4, w // 4, cfg.feature_channels, cfg.num_heads, \
        cfg.num_transformer
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
    selfs[(8, tokens, 2 * c // 8)] += 2 * cfg.refine_iter  # local refiner UNet
    return {"scanline_attention": selfs, "scanline_cross_attention": cross,
            "fused_correlation_ot": Counter({(1, h4, w4, c): 1})}


def time_ms(fn, n=20, warmup=3):
    """Median of n single-call CUDA-event timings, after warmup calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cost(name, shape, dtype_name):
    """(bytes, flops) the function must move and do: each input read once,
    each output written once; the matrix products' flops."""
    isz = 4 if dtype_name == "float32" else 2
    if name == "fused_correlation_ot":
        b, h, w, c = shape
        return (2 * b * h * w * c + 2 * b * h * w * w) * isz, 2 * b * h * w * w * c
    b, n, d = shape
    ndir = 2 if name == "scanline_cross_attention" else 1
    return ndir * 4 * b * n * d * isz, ndir * 4 * b * n * n * d


def bound(name, shape, dtype_name):
    """(bytes ms, operations ms): the bytes over the memory rate and the flops
    over the peak rate for the dtype; the bound is the larger of the two."""
    nbytes, flops = cost(name, shape, dtype_name)
    return 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_FLOPS[dtype_name]


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[torch.cuda.current_device()]
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


def phase_build():
    from s2m2_torch.ops import _build
    seconds = _build.build_all()
    ptxas = {}
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        ptxas[log.stem] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})


def _max_err_ok(got, ref, dtype_name, kind):
    """(max|diff|, bound description, ok) for one output."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    err = float(diff.max())
    if dtype_name == "bfloat16":
        limit = 2e-2 * float(ref.abs().max())
        return err, f"<= 2e-2*max|ref| = {limit:.3e}", err <= limit
    if kind == "prob":
        excess = float((diff - (1e-6 + 1e-4 * ref.abs())).max())
        return err, "<= 1e-6 + 1e-4*|ref|", excess <= 0
    limit = 1e-3 if kind == "cv" else 1e-4
    return err, f"<= {limit:g}", err <= limit


def phase_kernels(shapes):
    import torch
    import torch.nn.functional as F
    from s2m2_torch.models.layers import layer_norm
    from s2m2_torch.ops import flash_attention as fa
    from s2m2_torch.ops import sinkhorn

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    results = {name: {"float32": [], "bfloat16": []} for name in shapes}
    # top-scale head dims of M (192: tensor-core path in bf16) and XL (384:
    # scalar path), 64 image rows each; not on the S main path
    extra = {"scanline_attention": [(64, 304, 192), (64, 304, 384)]}
    failures = []
    for name, counter in shapes.items():
        todo = [(s, n) for s, n in counter.items()] + [(s, 0) for s in extra.get(name, [])]
        for shape, per_forward in todo:
            for dtype in (torch.float32, torch.bfloat16):
                dn = str(dtype).split(".")[1]
                if name == "fused_correlation_ot":
                    f0, f1 = (layer_norm(torch.randn(shape, generator=g, device=dev))
                              .to(dtype) for _ in range(2))
                    got = sinkhorn.fused_correlation_ot(f0, f1)
                    ref = sinkhorn.fused_correlation_ot_plain(f0, f1)
                    checks = [("prob", got[0], ref[0]), ("cv", got[1], ref[1])]
                    kern = lambda: sinkhorn.fused_correlation_ot(f0, f1)  # noqa: E731
                    plain = lambda: sinkhorn.fused_correlation_ot_plain(f0, f1)  # noqa: E731
                    lib = None
                else:
                    n_in = 6 if name == "scanline_cross_attention" else 3
                    xs = [torch.randn(shape, generator=g, device=dev).to(dtype)
                          for _ in range(n_in)]
                    fn = getattr(fa, name)
                    plain_fn = getattr(fa, name + "_plain")
                    got, ref = fn(*xs), plain_fn(*xs)
                    if n_in == 3:
                        got, ref = (got,), (ref,)
                    checks = [("attn", a, b) for a, b in zip(got, ref)]
                    kern = lambda: fn(*xs)  # noqa: E731
                    plain = lambda: plain_fn(*xs)  # noqa: E731
                    # (B, 1, N, D) views: SDPA's fused backends take 4D inputs
                    x4 = [x.unsqueeze(1) for x in xs]
                    if n_in == 3:
                        lib = lambda: F.scaled_dot_product_attention(*x4)  # noqa: E731
                    else:
                        qx, kx, vx, qy, ky, vy = x4
                        lib = lambda: (F.scaled_dot_product_attention(qx, ky, vy),  # noqa: E731
                                       F.scaled_dot_product_attention(qy, kx, vx))
                torch.cuda.synchronize()
                errs = []
                for kind, a, b in checks:
                    err, limit, ok = _max_err_ok(a, b, dn, kind)
                    errs.append({"output": kind, "max_abs_err": err, "bound": limit,
                                 "ok": ok})
                    if not ok:
                        failures.append((name, shape, dn, kind, err, limit))
                rec = {"kernel": name, "shape": list(shape), "dtype": dn,
                       "per_forward": per_forward, "checks": errs,
                       "ms": time_ms(kern), "plain_ms": time_ms(plain),
                       "library_ms": time_ms(lib) if lib else None,
                       "bound_ms": max(bound(name, shape, dn)),
                       "bound_parts_ms": bound(name, shape, dn)}
                emit({"phase": "kernels", **rec})
                results[name][dn].append(rec)
    if failures:
        raise AssertionError(f"kernel/plain disagreement: {failures}")
    return results


def phase_golden():
    import torch
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.models.s2m2 import S2M2
    from s2m2_torch.tools.convert import load_npz

    paths = sorted(glob.glob(str(ROOT / "tests" / "golden" / "s2m2_*.npz")))
    if not paths:
        raise FileNotFoundError("no tests/golden/s2m2_*.npz fixtures")
    for path in paths:
        with np.load(path) as z:
            meta = list(z["__meta"])
            img0 = np.transpose(z["__img0"], (0, 2, 3, 1))
            img1 = np.transpose(z["__img1"], (0, 2, 3, 1))
            refs = [np.transpose(z[k], (0, 2, 3, 1)) for k in ("__disp", "__occ", "__conf")]
        cfg = ModelConfig(feature_channels=int(meta[0]), num_transformer=int(meta[1]),
                          refine_iter=int(meta[2]),
                          use_positivity=bool(meta[3]) if len(meta) > 3 else True,
                          output_upsample=bool(meta[4]) if len(meta) > 4 else False)
        model = S2M2(cfg)
        model.load_state_dict(load_npz(path))
        model = model.cuda().eval()
        with torch.inference_mode():
            outs = model(torch.from_numpy(img0).cuda(), torch.from_numpy(img1).cuda())
        d, o, c = (t.float().cpu().numpy() for t in outs)
        errs = {"disp": float(np.abs(d - refs[0]).max()),
                "occ": float(np.abs(o - refs[1]).max()),
                "conf": float(np.abs(c - refs[2]).max()),
                "epe": float(np.abs(d - refs[0]).mean())}
        ok = (errs["disp"] <= 2e-2 and errs["occ"] <= 2e-3 and errs["conf"] <= 2e-3
              and errs["epe"] < 1e-3)
        emit({"phase": "golden", "fixture": os.path.basename(path), **errs,
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


FAMILIES = (("ours: scanline attention", ("attention_kernel", "attention_mma_kernel")),
            ("ours: correlation + Sinkhorn", ("corr_ot_kernel",)),
            ("convolution (cuDNN)", ("fprop", "implicit", "conv", "cudnn", "winograd",
                                     "fft")),
            ("matrix product (cuBLAS)", ("gemm", "cutlass", "cublas", "splitk")),
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


def phase_main_path(shapes):
    import torch
    from s2m2_torch.ops import _build
    from s2m2_torch.runtime.engine import StereoEngine

    rng = np.random.default_rng(0)
    pairs = [_stereo_pair(rng, H, W, 16 + 8 * i) for i in range(N_REQUESTS)]
    per_forward = {k: sum(v.values()) for k, v in shapes.items()}
    launches = Counter()
    for precision in ("fp32", "bf16"):
        eng = StereoEngine("S", precision=precision, seed=0)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        ms = []
        for left, right in pairs:
            disp, occ, conf, score, t = eng.run(left, right)
            for name, arr in (("disp", disp), ("occ", occ), ("conf", conf)):
                if arr.shape != (H, W) or not np.isfinite(arr).all():
                    raise AssertionError(f"{precision}: {name} not finite (H, W)")
            if disp.min() < 0 or occ.min() < 0 or occ.max() > 1 or conf.min() < 0 \
                    or conf.max() > 1:
                raise AssertionError(f"{precision}: outputs out of range")
            ms.append(t)
        counts = dict(_build.launch_counts)
        launches.update(counts)
        for name, n in per_forward.items():
            if counts[name] != n * N_REQUESTS:
                raise AssertionError(f"{precision}: {name} launched {counts[name]} "
                                     f"times, expected {n} x {N_REQUESTS}")
        med = float(np.median(ms))
        peak = torch.cuda.max_memory_allocated()
        emit(profile_forward(eng, precision, *pairs[0]))
        emit({"phase": "main_path", "model": "S", "precision": precision,
              "height": H, "width": W, "requests": N_REQUESTS, "ms_per_frame": ms,
              "median_ms": med, "fps": 1e3 / med, "max_memory_allocated": peak,
              "launches": counts, "score_last": score,
              "benchmark": eng.benchmark(H, W, n_warmup=1, n_iter=5)})
        del eng
        torch.cuda.empty_cache()
    return launches


def kernels_line(results, launches):
    """One entry per kernel. ms, plain_ms, library_ms and bound_ms are sums
    over the launches of one bf16 S 1216x1024 forward (each shape's time
    times its launches per forward); `fp32` holds the same sums in float32.
    max_abs_err is the largest over all of the kernel's comparisons."""
    out = []
    for name, by_dtype in results.items():
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "launches": launches[name]}
        for dn, recs in by_dtype.items():
            main = [r for r in recs if r["per_forward"] > 0]
            tot = lambda key: sum(r[key] * r["per_forward"] for r in main)  # noqa: E731
            by_bytes = sum(r["bound_parts_ms"][0] * r["per_forward"] for r in main)
            by_ops = sum(r["bound_parts_ms"][1] * r["per_forward"] for r in main)
            sums = {"ms": tot("ms"), "plain_ms": tot("plain_ms"),
                    "bound_ms": tot("bound_ms"),
                    "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                    "library_ms": None if main[0]["library_ms"] is None
                    else tot("library_ms"),
                    "max_abs_err": max(c["max_abs_err"] for r in recs
                                       for c in r["checks"])}
            if dn == "bfloat16":
                entry.update(sums)
            else:
                entry["fp32"] = sums
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

    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    shapes = main_path_shapes(get_config("S"), H, W)
    results = phase_kernels(shapes)
    phase_golden()
    launches = phase_main_path(shapes)
    for name in shapes:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    print(json.dumps({"kernels": kernels_line(results, launches)}))
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
