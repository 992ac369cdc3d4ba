"""Measurements on a CUDA card that chip_smoke.py does not make.

    python3 s2m2_torch/tools/chip_probe.py fill [--out FILE]
    python3 s2m2_torch/tools/chip_probe.py dispatch [--out FILE]
    python3 s2m2_torch/tools/chip_probe.py sweep [--out FILE]
    python3 s2m2_torch/tools/chip_probe.py int8 [--out FILE]
    python3 s2m2_torch/tools/chip_probe.py dblock [--label NAME] [--trace] [--out FILE]
    python3 s2m2_torch/tools/chip_probe.py drift [--out FILE]
    python3 s2m2_torch/tools/chip_probe.py ot [--label NAME] [--trace] [--out FILE]
    python3 s2m2_torch/tools/chip_probe.py requests --model S \
        --precision bf16,int8a,int8r --n 16 [--label NAME] [--via-ops] [--out FILE]
    python3 s2m2_torch/tools/chip_probe.py calib [--n 20] [--out FILE]
    python3 s2m2_torch/tools/chip_probe.py sensitivity [--seeds 4] [--out FILE]
    python3 s2m2_torch/tools/chip_probe.py fattn [--label NAME] [--models S,XL]
        [--forward] [--trace] [--out FILE]

`fill`: kernel A in bf16 at head dim 32 with N = 1216 (S's 2D blocks) and at
(B, 304, 128) (S's 1x scale), over a range of sequence counts B, with
F.scaled_dot_product_attention on the same inputs. The time per sequence
says whether a launch of the model's B fills the card. At (B, 1216, 32) it
also times D = 32 instances of 2, 4 and 8 warps (32, 64 and 128 queries a
block; built into their own directories under build/), so the size of the
query tile is measured too. Each time is
given three ways: CUDA events over 10 back-to-back calls (as chip_smoke.py
times A and B), the kernels' device time under torch.profiler, and the
host's time per call; where the host's is the larger, the event time
measures the dispatch, not the kernel.

`dispatch`: the host time of each step of kernel A's wrapper at one small
2D-block shape, beside the whole wrapper and SDPA's call; and of kernel
E's two wrappers (`quantize_pack`, `int8_gemm`) on token rows, beside
`torch._int_mm` on the same rows. Beside each of A's and E's wrappers, the
same call through its custom op (`torch.ops.s2m2_torch.*`,
ops/library.py): what serving would pay a launch for going through the
dispatcher, as exported programs do.

`int8`: kernel E at every distinct call one XL int8 1216x1024 forward
makes. The forward runs once with E's two wrappers wrapped so that the
first call of each distinct argument signature is kept; each kept call is
then replayed as the model made it and timed three ways: its device time
under torch.profiler, CUDA events over one call (what chip_smoke.py's
per-shape records took until they timed device work), and the host's
time per call. Beside them, `torch._int_mm`'s device time on int8 rows of
the GEMM's (M, K padded to 32, N), and the bound of each site's own work
(`site_work`). It uses only E's public wrappers and `quant.last_log()`,
so it also runs against an older checkout (`PYTHONPATH=<checkout>`).

`dblock`: kernel D at XL 1216x1024's two fused shapes, (256, 304, 384, 1)
and (128, 152, 384, 2) as (pairs, W, C, heads), in bf16 and float32, with
the port's seeded block weights: the kernel's time by CUDA events over 5
back-to-back calls and by device time under torch.profiler, beside the
port's unfused block on the same rows (A/B and cuBLAS); and the largest
difference from the plain version. It uses only the public wrapper, so it
also runs against an older checkout (`PYTHONPATH=<checkout>`). With
`--trace`, kernel D is built with S2M2_D_TRACE into its own directory and,
instead, each shape reports the share of the consumers' cycles in each
stage of the kernel (waits, layer norms, epilogues, the attention's
steps) and the producer's cycles spent waiting for a free stage.

`drift`: the int8 engine's disparity drift (mean |disp - reference|, px)
on the golden fixture tests/golden/s2m2_c32_ntr1_neg_up.npz, as chip_smoke.py
phase 4 measures it, then again with one route at a time run by its plain
PyTorch version on the card: A, B, C, E's GEMM, and the bf16 cuDNN
convolutions computed in float32 (TF32 off) and rounded back; each route's
swap covers calibration and forward alike.

`ot`: kernel C at S's and XL's 1216x1024 matcher shapes, (1, 256, 304,
128) and (1, 256, 304, 384), and at W = 608, (1, 128, 608, 128), in bf16
and float32 with positivity on: CUDA events over 10 back-to-back calls
and over one call, the device time under torch.profiler, the plain
version's event and device time, the largest difference from it (prob and
cv), and the device memory one call adds beyond its inputs (outputs plus
any workspace). It uses only the public wrapper, so it also runs against
an older checkout (`PYTHONPATH=<checkout>`); the plan, and how many of its
clusters fit on the card at once, are reported where the checkout has
them. With `--trace`, kernel C is built with S2M2_C_TRACE into its own
directory and each shape instead reports the cycles thread 0 of a CTA
spends in each stage of the resident route (the correlation's main loop
and epilogue, the column sweeps' items, local merge, cluster barrier and
merge, the row sweeps, the final pass, the exit wait), summed over the
correlation's passes and the Sinkhorn iterations.

`sweep`: kernel A's device time in bf16 for a few instances per padded D
(`SWEEP`) at the model's shapes, beside SDPA's and the compiled instance's.

`requests`: for each precision in turn, one StereoEngine (seeded random
weights) serving `--n` requests on 1216x1024 pairs after one warm-up
request (which calibrates an int8 engine), printing every request's ms
and the device busy ms of one more forward under torch.profiler (which a
host-bound request time hides). It uses only the engine's public API, so
it also runs against an older
checkout of the package:
`PYTHONPATH=<checkout> python3 s2m2_torch/tools/chip_probe.py requests ...`.
`--via-ops` routes every
kernel call of the engines through its custom op (the wrappers'
`_build.via_op` made true), so serving through the dispatcher is timed
against the direct launches; an older checkout has no such route.

`calib`: where the time of an online-calibration candidate goes, on
chip_smoke.py phase 8's engine (S bf16, seed 0), raw pair (phase 5's first,
uint8) and synthetic 1216x1024 sensor calibration. Four runs of `--n`
engine calls each, in turns: (a) requests back to back on the rectified
pair; (b) candidates as `evaluate_sample` runs them (numpy maps, native
remap, request) for seeded deltas of 2 mrad; (c) requests each after
building the maps of a candidate but not remapping; (d) requests each
after remapping the pair with fixed maps. Each reports the median host ms
of the maps, the remap, the engine call (`score_ms`) and the forward alone
(`run()`'s own ms), so (c) and (d) say whether the host's numpy work slows
the forward that follows it. Then one candidate under torch.profiler: the
device's busy ms beside the candidate's wall ms.

`sensitivity`: how far the unsharded S engine's outputs move under a 1e-6
relative change of its input: the control that fixes chip_smoke.py phase
12's float bounds. For each of phase 12's unsharded float cells (fp32;
bf16; bf16 with two pairs a request; bf16 with the fused block) on phase
12's 3 requests (seeded `stereo_pair`s, 1216x1024): every request served
twice as it is (the second must repeat the first to the bit), then with
its left image scaled by 1 + 1e-6 (phase 12's former control) and with
each of `--seeds` seeded perturbations of it (every pixel times 1 + 1e-6
u, u uniform in [-1, 1]). Each reading is taken over all 3 requests: the
largest |d disp|, |d occ| and |d conf| and the mean |d disp|; the cell's
line holds every reading and their maxima.

`fattn`: kernel F (the int8_attn core) through its public wrapper at every
shape one int8_attn forward of each of `--models` at 1216x1024 gives it
(chip_smoke.py's `int8_attn_shapes`), in bf16 and float32, on chip_smoke
phase 3's seeded inputs: CUDA events over 10 back-to-back calls (median of
10), the device time under torch.profiler, `agreement` with the plain
version, the shape's bound (bytes, int8 operations) and the host's us a
call; each line carries the shape's launches a forward, so the sums a
forward follow, and (this checkout) the shape's plan and how many blocks of
it an SM holds; then the host us of each step of the wrapper at S's
smallest shape (`fattn_dispatch`). With `--forward`, an S int8 engine with int8_attn (seed 0) calibrates, serves
one request and runs one forward under torch.profiler: its device busy
ms and F's kernels' share. It uses only the public wrapper and engine,
so it also runs against an older checkout (`PYTHONPATH=<checkout>`). With
`--trace`, kernel F is built with S2M2_F_TRACE into its own directory and,
instead, each shape reports the share of a unit's cycles in each stage
(the waits for Q and for each stage, pass 1's scores and row max, pass
2's scores with the previous P V^T, its probabilities, its P V^T issue,
the epilogue) and the producer's waits for a free stage.

Every result is one JSON line on stdout (and appended to `--out`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

H, W = 1024, 1216


def emit(obj, out):
    line = json.dumps(obj, default=str)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def time_ms(fn, n=20, warmup=3, reps=10):
    """Median over n CUDA-event timings of `reps` back-to-back calls, per call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def _use_table(table, build_dir):
    """Point kernels A and B at the instance table `table` ({dtype: {DP:
    (warps, m-tiles, WN, BK, stages, blocks per SM)}}), built into
    `build_dir`; None restores the compiled table and build directory."""
    from s2m2_torch.ops import _build
    from s2m2_torch.ops import flash_attention as fa
    if not hasattr(_use_table, "saved"):
        _use_table.saved = (fa._INSTANCES, _build.BUILD_DIR)
    fa._INSTANCES, _build.BUILD_DIR = (table, build_dir) if table else _use_table.saved
    _build._libs.clear()
    _build.entry.cache_clear()
    fa.plan.cache_clear()


def device_us(fn, n=20):
    """Device time of one call, in microseconds: the CUDA kernels' own time
    under torch.profiler over n calls, divided by n."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / n


def host_us(fn, n=200):
    """Host time of one call, in microseconds: n calls queued without a
    synchronization (the card runs behind), divided by n."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def cmd_fill(args):
    import torch
    import torch.nn.functional as F
    from s2m2_torch.ops import _build
    from s2m2_torch.ops import flash_attention as fa
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [(b, 1216, 32) for b in (8, 16, 32, 64, 128)] + \
        [(b, 304, 128) for b in (32, 128, 512, 1024)] + \
        [(512, 152, 64), (512, 76, 64), (8, 1216, 16)]  # the rest of S's A shapes
    variants = [("compiled", None)] + [
        (f"{w} warps, {16 * w} queries", (w, 1, 1, 64, 2, 2)) for w in (2, 4, 8)]
    for label, inst in variants:
        if inst is not None:
            table = {dt: dict(t) for dt, t in fa._INSTANCES.items()}
            table[torch.bfloat16][32] = inst
            _use_table(table, _build.BUILD_DIR.parent / f"probe_d32_{inst[0]}w")
        for shape in cases:
            if inst is not None and shape[-1] != 32:
                continue
            q, k, v = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                       for _ in range(3))
            p = fa.plan(torch.bfloat16, shape[-1])
            err = float((fa.scanline_attention(q, k, v).float()
                         - fa.scanline_attention_plain(q, k, v).float()).abs().max())
            q4, k4, v4 = (x.unsqueeze(1) for x in (q, k, v))
            ours = lambda: fa.scanline_attention(q, k, v)  # noqa: E731, B023
            sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4)  # noqa: E731, B023
            blocks = shape[0] * -(-shape[1] // p.bq)
            rec = {"probe": "fill", "instance": label, "shape": list(shape), "bq": p.bq,
                   "warps": p.warps, "blocks": blocks, "warps_per_sm": blocks * p.warps / sms,
                   "max_abs_err": err}
            for name, fn in (("ours", ours), ("sdpa", sdpa)):
                rec[name] = {"event_ms": time_ms(fn), "device_us": device_us(fn),
                             "host_us": host_us(fn)}
                rec[name]["device_us_per_sequence"] = rec[name]["device_us"] / shape[0]
            emit(rec, args.out)
        _use_table(None, None)


# bf16 instances timed by `sweep`, per padded D: the compiled one and a few
# others (more warps and queries per block, longer key tiles, more
# stages), each at the shapes of kernel A with that D in an S or XL
# 1216x1024 forward
SWEEP = {
    16: ([(8, 1216, 16)], [(8, 1, 1, 64, 2, 2)]),
    32: ([(16, 1216, 32), (8, 1216, 32)], [(4, 1, 1, 64, 2, 2), (8, 1, 1, 64, 3, 2),
                                           (4, 2, 1, 64, 2, 2)]),
    48: ([(8, 1216, 48)], [(8, 1, 1, 64, 2, 2)]),
    64: ([(512, 152, 64), (512, 76, 64)], [(8, 1, 1, 32, 2, 2), (8, 1, 1, 64, 2, 2),
                                           (4, 1, 1, 64, 2, 4)]),
    96: ([(16, 1216, 96), (8, 1216, 96)], [(8, 1, 1, 64, 2, 2), (8, 1, 1, 32, 2, 2)]),
    128: ([(512, 304, 128)], [(8, 1, 1, 32, 2, 2), (8, 1, 1, 64, 2, 2), (4, 2, 1, 32, 2, 2),
                              (8, 1, 1, 32, 3, 2), (4, 1, 1, 64, 2, 2)]),
    192: ([(512, 152, 192), (512, 76, 192)], [(8, 1, 1, 32, 2, 1), (8, 1, 1, 32, 3, 1)]),
}


def cmd_sweep(args):
    """Kernel A's device time in bf16 for each instance of SWEEP beside the
    compiled one, every instance built alone (a one-instance table) into
    its own directory, all builds started together; each checked against
    the plain version and for register spills."""
    import re
    import torch
    import torch.nn.functional as F
    from s2m2_torch.ops import _build
    from s2m2_torch.ops import flash_attention as fa
    name = "scanline_attention"
    root = _build.BUILD_DIR.parent
    compiled = fa._INSTANCES[torch.bfloat16]
    runs, started = [], []
    for dp, (shapes, insts) in SWEEP.items():
        for inst in [compiled[dp], *insts]:
            table = {torch.float32: {}, torch.bfloat16: {dp: inst}}
            build_dir = root / ("sweep_" + "_".join(map(str, (dp, *inst))))
            _use_table(table, build_dir)
            runs.append((dp, inst, shapes, table, build_dir, inst == compiled[dp]))
            started.append(_build._start_build(name))
    for (*_, table, build_dir, _), st in zip(runs, started):
        _use_table(table, build_dir)
        if st is not None:
            _build._finish_build(name, st)
    g = torch.Generator(device="cuda").manual_seed(0)
    sdpa_us = {}
    for dp, inst, shapes, table, build_dir, is_compiled in runs:
        _use_table(table, build_dir)
        log = (build_dir / f"{name}.log").read_text()
        spills = re.findall(r"([1-9]\d*) bytes spill (?:stores|loads)", log)
        for shape in shapes:
            q, k, v = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                       for _ in range(3))
            ref = fa.scanline_attention_plain(q, k, v).float()
            err = float((fa.scanline_attention(q, k, v).float() - ref).abs().max())
            if shape not in sdpa_us:
                q4, k4, v4 = (x.unsqueeze(1) for x in (q, k, v))
                sdpa_us[shape] = device_us(
                    lambda: F.scaled_dot_product_attention(q4, k4, v4))  # noqa: B023
            p = fa.plan(torch.bfloat16, dp)
            emit({"probe": "sweep", "dp": dp, "instance": list(inst), "compiled": is_compiled,
                  "bq": p.bq, "smem": p.smem, "shape": list(shape), "spill_bytes": spills,
                  "ok": err <= 2e-2 * float(ref.abs().max()), "max_abs_err": err,
                  "device_us": device_us(lambda: fa.scanline_attention(q, k, v)),  # noqa: B023
                  "sdpa_device_us": sdpa_us[shape]}, args.out)
    _use_table(None, None)


def cmd_dispatch(args):
    """Host microseconds of each step of kernel A's wrapper at (8, 1216, 32)
    bf16, beside the whole wrapper and SDPA's call, and of kernel E's
    wrappers (`_e_dispatch`)."""
    import ctypes

    import torch
    import torch.nn.functional as F
    from s2m2_torch.ops import _build
    from s2m2_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((8, 1216, 32), generator=g, device="cuda").bfloat16()
               for _ in range(3))
    q4, k4, v4 = (x.unsqueeze(1) for x in (q, k, v))
    out = fa.scanline_attention(q, k, v)
    lib, fn = fa._entry()
    spare = lib["s2m2_error_string"]  # a second handle: its signature is not used
    p = fa.plan(q.dtype, 32)
    dev = q.device
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()] * 2
    stream = torch.cuda.current_stream(dev).cuda_stream

    def device_ctx():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    steps = {
        "wrapper": lambda: fa.scanline_attention(q, k, v),
        "sdpa": lambda: F.scaled_dot_product_attention(q4, k4, v4),
        "check": lambda: fa._check((q, k, v)),
        "plan": lambda: fa.plan(q.dtype, 32),
        "contiguous": lambda: all(t.is_contiguous() for t in (q, k, v)),
        "data_ptr x3": lambda: (q.data_ptr(), k.data_ptr(), v.data_ptr()),
        "empty": lambda: torch.empty((8, 1216, 32), dtype=q.dtype, device=dev),
        "device ctx + stream": device_ctx,
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "current_device": torch.cuda.current_device,
        "ctypes launch": lambda: _build.check(lib, fn(*ptrs, 8, 1216, 32, 1, p.dp, p.bq,
                                                      p.smem, 1, stream), "probe"),
        "ctypes argtypes (16)": lambda: setattr(spare, "argtypes", [ctypes.c_void_p] * 16),
        "a custom op": lambda: torch.ops.s2m2_torch.scanline_attention(q, k, v),
        **_e_dispatch(),
    }
    emit({"probe": "dispatch", "shape": [8, 1216, 32], "dtype": "bfloat16",
          "host_us": {name: host_us(f, n=1000) for name, f in steps.items()}}, args.out)


def _e_dispatch():
    """Host microseconds of kernel E's wrappers on (1216, 96) bf16 token
    rows against a (64, 96) int8 weight, beside torch._int_mm on the rows."""
    import torch
    from s2m2_torch.ops import int8_gemm as ig
    from s2m2_torch.ops import library  # noqa: F401  (registers the custom ops)
    ops = torch.ops.s2m2_torch
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1216, 96), generator=g, device="cuda").bfloat16()
    w = torch.randint(-127, 128, (64, 96), generator=g, device="cuda", dtype=torch.int8)
    s_w = torch.rand((64,), generator=g, device="cuda") * 1e-3
    bias = torch.randn((64,), generator=g, device="cuda")
    a = ig.quantize_pack(x, 20.0)
    wt = w.t()
    return {"e pack wrapper": lambda: ig.quantize_pack(x, 20.0),
            "e pack custom op": lambda: ops.int8_quantize_pack(x, 20.0, None, None, False),
            "e gemm wrapper": lambda: ig.int8_gemm(a, w, s_w, 0.05, bias, torch.bfloat16),
            "e gemm custom op": lambda: ops.int8_gemm(a, w, s_w, 0.05, bias, torch.bfloat16,
                                                      None, None),
            "int_mm": lambda: torch._int_mm(a, wt)}


def site_work(log):
    """(bytes, operations) of each int8 site of a quantized forward, from
    its `quant.last_log()` records: a pack record opens a site (a chunk of
    an explicit im2col site counts as a site of its rows), the GEMM records
    after it belong to it. Bytes: the activation once in its dtype (its
    share of the rows for a chunk), each GEMM's int8 weight (N x K, K the
    true reduction depth), its output once and its float32 scale and bias;
    a site with no GEMM (an int8r residual store) writes its int8 rows.
    Operations: 2 M N K per GEMM. This is the same whatever the kernels'
    design."""
    size = {"torch.bfloat16": 2, "torch.float32": 4}
    sites = []
    for r in log:
        if r["kind"] == "pack":
            numel = int(np.prod(r["in_shape"]))
            share = 1.0
            if r.get("layout", "im2col" if r["conv"] else "rows") == "im2col":
                kh, kw, sh, sw, ph, pw = r["conv"]
                b, _, h, w = r["in_shape"]
                ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
                share = r["rows"] / (b * ho * wo)
            elif not r["conv"] and r.get("layout", "rows") == "rows":
                numel = r["rows"] * r["k"]
            sites.append({"bytes": numel * size[r["dtype"]] * share,
                          "rows_out": r["rows"] * r["kp"], "ops": 0, "gemms": 0})
        elif r["kind"] == "gemm" and sites:
            site = sites[-1]
            site["bytes"] += (r["n"] * r["k"] + r["m"] * r["n"] * size[r["out"]]
                              + 8 * r["n"])
            site["ops"] += 2 * r["m"] * r["n"] * r["k"]
            site["gemms"] += 1
    return [(s["bytes"] + (0 if s["gemms"] else s["rows_out"]), s["ops"]) for s in sites]


def _signature(args, kwargs):
    """A hashable key of a call's arguments: tensors by shape, strides and
    dtype, floats (the sites' scales) by type alone, everything else by
    value; calls with one key do the same work."""
    import torch

    def key(v):
        if isinstance(v, torch.Tensor):
            return ("T", tuple(v.shape), v.stride(), str(v.dtype))
        return "float" if isinstance(v, float) else repr(v)
    return (tuple(key(a) for a in args), tuple((k, key(v)) for k, v in sorted(kwargs.items())))


def cmd_int8(args):
    """Kernel E at every distinct call of one XL int8 1216x1024 forward."""
    import torch
    from s2m2_torch.models import quant
    from s2m2_torch.ops import _build
    from s2m2_torch.ops import int8_gemm as ig
    from s2m2_torch.runtime.engine import StereoEngine
    _build.build_all()
    rng = np.random.default_rng(0)
    left, right = _pair(rng, 16)
    eng = StereoEngine("XL", precision="int8", seed=0)
    eng._auto_calibrate(left[None], right[None])
    eng.forward_padded(left[None], right[None])  # warm
    kept, counts = {}, {}
    originals = {name: getattr(ig, name) for name in ("quantize_pack", "int8_gemm")}

    def keeper(name):
        def call(*a, **kw):
            sig = (name, _signature(a, kw))
            counts[sig] = counts.get(sig, 0) + 1
            if sig not in kept:
                kept[sig] = (a, kw)
            return originals[name](*a, **kw)
        return call

    for name in originals:
        setattr(ig, name, keeper(name))
    try:
        eng.forward_padded(left[None], right[None])
    finally:
        for name, fn in originals.items():
            setattr(ig, name, fn)
    log = quant.last_log()
    work = site_work(log)
    peak_bytes, peak_ops = 3.35e12, 1979e12
    bound_ms = sum(1e3 * max(b / peak_bytes, o / peak_ops) for b, o in work)
    recs = []
    for (name, _), (a, kw) in kept.items():
        fn = originals[name]
        sig = (name, _signature(a, kw))
        t = [x for x in (*a, *kw.values()) if isinstance(x, torch.Tensor)]
        rec = {"kernel": name, "per_forward": counts[sig],
               "shapes": [list(x.shape) for x in t], "dtypes": [str(x.dtype) for x in t],
               "args": [v for v in a if not isinstance(v, torch.Tensor)],
               "kwargs": {k: v for k, v in kw.items() if not isinstance(v, torch.Tensor)},
               "device_us": device_us(lambda: fn(*a, **kw), n=10),  # noqa: B023
               "event_ms_single": time_ms(lambda: fn(*a, **kw), n=10, reps=1),  # noqa: B023
               "host_us": host_us(lambda: fn(*a, **kw), n=50)}  # noqa: B023
        recs.append(rec)
        emit({"probe": "int8_call", **rec}, args.out)
    lib = {}
    for r in log:
        if r["kind"] != "gemm":
            continue
        key = (r["m"], (r["k"] + 31) // 32 * 32, r["n"])
        if key in lib:
            lib[key]["per_forward"] += 1
            continue
        m, kp, n = key
        entry = {"m": m, "kp": kp, "n": n, "per_forward": 1, "device_us": None}
        if m > 16 and n % 8 == 0:
            a = torch.randint(-127, 128, (m, kp), device="cuda", dtype=torch.int8)
            wt = torch.randint(-127, 128, (n, kp), device="cuda", dtype=torch.int8).t()
            try:
                torch._int_mm(a, wt)
                entry["device_us"] = device_us(lambda: torch._int_mm(a, wt), n=10)  # noqa: B023
            except RuntimeError:
                pass
            del a, wt
        lib[key] = entry
    tot = {}
    for name in originals:
        mine = [r for r in recs if r["kernel"] == name]
        tot[name] = {k: sum(r[k] * r["per_forward"] for r in mine) / 1e3
                     for k in ("device_us", "host_us")}
        tot[name]["event_ms_single"] = sum(r["event_ms_single"] * r["per_forward"]
                                           for r in mine)
        tot[name]["launches"] = sum(r["per_forward"] for r in mine)
        tot[name]["distinct_calls"] = len(mine)
    took = [e for e in lib.values() if e["device_us"] is not None]
    top = sorted(recs, key=lambda r: -r["per_forward"] * r["device_us"])[:10]
    emit({"probe": "int8_forward", "package": __import__("s2m2_torch").__file__,
          "sites": len(work), "site_bound_ms": bound_ms,
          "site_bytes": sum(b for b, _ in work), "site_ops": sum(o for _, o in work),
          "pack_ms": tot["quantize_pack"], "gemm_ms": tot["int8_gemm"],
          "int_mm_device_ms": sum(e["device_us"] * e["per_forward"] for e in took) / 1e3,
          "int_mm_launches": sum(e["per_forward"] for e in took),
          "int_mm_shapes": [[e["m"], e["kp"], e["n"], e["per_forward"], e["device_us"]]
                            for e in took],
          "top10_by_device_time": [[r["kernel"], r["shapes"], r["kwargs"], r["per_forward"],
                                    r["device_us"]] for r in top]}, args.out)


def _pair(rng, disp):
    base = rng.uniform(0, 255, (H // 8 + 1, W // 8 + 1, 3)).astype(np.float32)
    left = np.repeat(np.repeat(base, 8, 0), 8, 1)[:H, :W]
    right = np.roll(left, -disp, axis=1)
    return left, right


def cmd_requests(args):
    import torch
    from torch.profiler import ProfilerActivity, profile
    import s2m2_torch
    from s2m2_torch.ops import _build
    from s2m2_torch.runtime.engine import StereoEngine
    _build.build_all()
    if args.via_ops:
        from s2m2_torch.ops import library  # noqa: F401  (registers the custom ops)
        _build.via_op = lambda t: True
    rng = np.random.default_rng(0)
    pairs = [_pair(rng, 16 + 8 * (i % 8)) for i in range(8)]
    for precision in args.precision.split(","):
        eng = StereoEngine(args.model, precision=precision, seed=0)
        t0 = time.perf_counter()
        eng.run(*pairs[0])  # warm-up; calibrates an int8 engine
        warm_s = time.perf_counter() - t0
        ms = [float(eng.run(*pairs[i % len(pairs)])[4]) for i in range(args.n)]
        left, right = (x[None] for x in pairs[0])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.forward_padded(left, right)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        emit({"probe": "requests", "label": args.label, "package": s2m2_torch.__file__,
              "via_ops": args.via_ops, "model": args.model, "precision": precision,
              "requests": args.n,
              "warmup_s": warm_s, "ms_per_request": ms, "median_ms": float(np.median(ms)),
              "mean_ms": float(np.mean(ms)),
              "device_busy_ms": busy if busy > 0 else "not measured"}, args.out)
        del eng
        torch.cuda.empty_cache()


# chip_smoke.py phase 12's unsharded float cells: (label, precision, fused
# block, pairs a request), 3 requests each
SENSITIVITY_CELLS = (("fp32", "fp32", False, 1), ("bf16", "bf16", False, 1),
                     ("bf16 two pairs", "bf16", False, 2),
                     ("bf16 fused", "bf16", True, 1))
SENSITIVITY_REQUESTS = 3


def cmd_sensitivity(args):
    import torch
    from s2m2_torch.demo._scenes import stereo_pair
    from s2m2_torch.runtime.engine import StereoEngine
    rng = np.random.default_rng(0)
    pairs = [stereo_pair(rng, H, W, 16 + 8 * i) for i in range(2 * SENSITIVITY_REQUESTS)]
    for label, precision, fused, per_request in SENSITIVITY_CELLS:
        batches = [tuple(np.stack([p[v] for p in pairs[per_request * i:per_request * (i + 1)]])
                         for v in (0, 1)) for i in range(SENSITIVITY_REQUESTS)]
        eng = StereoEngine("S", precision=precision, seed=0, fused_block=fused)
        eng.run(*batches[0])
        refs = [eng.run(a, b)[:3] for a, b in batches]
        repeat = max(float(np.abs(x - r).max()) for (a, b), ref in zip(batches, refs)
                     for x, r in zip(eng.run(a, b)[:3], ref))

        def reading(scale):
            d = [[np.abs(x - r) for x, r in zip(eng.run(a * s, b)[:3], ref)]
                 for (a, b), s, ref in zip(batches, scale, refs)]
            out = {f"{name}_max": max(float(req[i].max()) for req in d)
                   for i, name in enumerate(("disp", "occ", "conf"))}
            out["disp_mean"] = float(np.mean([req[0].mean() for req in d]))
            return out

        readings = [dict(perturbation="scale 1 + 1e-6",
                         **reading([np.float32(1 + 1e-6)] * len(batches)))]
        for seed in range(args.seeds):
            prng = np.random.default_rng(seed)
            readings.append(dict(perturbation=f"seed {seed}", **reading(
                [(1 + 1e-6 * prng.uniform(-1, 1, a.shape)).astype(np.float32)
                 for a, _ in batches])))
        emit({"probe": "sensitivity", "cell": label, "model": "S", "precision": precision,
              "fused_block": fused, "pairs_per_request": per_request,
              "requests": SENSITIVITY_REQUESTS, "repeat_max_abs": repeat, "readings": readings,
              "max": {k: max(r[k] for r in readings) for k in readings[0]
                      if k != "perturbation"},
              "device": torch.cuda.get_device_name(0)}, args.out)
        del eng
        torch.cuda.empty_cache()


def cmd_calib(args):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _stereo_pair, synthetic_calibration
    from s2m2_torch.calibration import base
    from s2m2_torch.runtime.engine import StereoEngine
    from s2m2_torch.utils.calib import compute_stereo_rectification, create_delta_rotation
    from s2m2_torch.utils.image import rectify_images
    raw = [np.rint(i).astype(np.uint8) for i in _stereo_pair(np.random.default_rng(0), H, W, 16)]
    calib = synthetic_calibration()
    rect = compute_stereo_rectification(calib, (W, H))
    pair = rectify_images(*raw, rect)
    eng = StereoEngine("S", precision="bf16", seed=0)
    deltas = np.random.default_rng(1).normal(0, 0.002, (args.n, 3))

    def request(p):
        t0 = time.perf_counter()
        fwd_ms = eng.run(*p)[4]
        return (time.perf_counter() - t0) * 1e3, fwd_ms

    def maps(d):
        t0 = time.perf_counter()
        r = compute_stereo_rectification(calib, (W, H), create_delta_rotation(*d))
        return r, (time.perf_counter() - t0) * 1e3

    def remap(r):
        t0 = time.perf_counter()
        p = rectify_images(*raw, r)
        return p, (time.perf_counter() - t0) * 1e3

    for _ in range(3):
        request(pair)
    runs = {"back_to_back": [], "candidates": [], "maps_then_request": [],
            "remap_then_request": []}
    for i in range(args.n):
        score_ms, fwd = request(pair)
        runs["back_to_back"].append({"score_ms": score_ms, "forward_ms": fwd})
        r, maps_ms = maps(deltas[i])
        p, remap_ms = remap(r)
        score_ms, fwd = request(p)
        runs["candidates"].append({"maps_ms": maps_ms, "remap_ms": remap_ms,
                                   "score_ms": score_ms, "forward_ms": fwd})
        _, maps_ms = maps(deltas[i])
        score_ms, fwd = request(pair)
        runs["maps_then_request"].append({"maps_ms": maps_ms, "score_ms": score_ms,
                                          "forward_ms": fwd})
        _, remap_ms = remap(rect)
        score_ms, fwd = request(pair)
        runs["remap_then_request"].append({"remap_ms": remap_ms, "score_ms": score_ms,
                                           "forward_ms": fwd})
    for name, recs in runs.items():
        emit({"probe": "calib", "run": name, "n": args.n,
              **{f"median_{k}": float(np.median([r[k] for r in recs])) for k in recs[0]}},
             args.out)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        base.evaluate_sample(eng, *raw, calib, *deltas[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    emit({"probe": "calib", "run": "profiled_candidate", "wall_ms": wall_ms,
          "device_busy_ms": busy if busy > 0 else "not measured",
          "idle_share": 1 - busy / wall_ms if busy > 0 else "not measured"}, args.out)


DBLOCK_SHAPES = ((256, 304, 384, 1), (128, 152, 384, 2))


def cmd_dblock(args):
    import torch
    from s2m2_torch.ops import _build
    if args.trace:  # a measurement build of kernel D, in its own directory
        _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DS2M2_D_TRACE=1")
        _build.BUILD_DIR = _build.BUILD_DIR.parent / "s2m2_torch_trace"
    from s2m2_torch.models.attention import BasicAttnBlock
    from s2m2_torch.models.init import _basic_attn_block, _Rng
    from s2m2_torch.ops import fused_block as fb
    from s2m2_torch.tools.convert import flatten, from_jax
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for n, w, c, heads in DBLOCK_SHAPES:
        blk = BasicAttnBlock(c, heads)
        blk.load_state_dict(from_jax(flatten(_basic_attn_block(_Rng(0), c, heads, 1))))
        for dtype in (torch.bfloat16, torch.float32):
            b = blk.to(dev, dtype)
            wts = b.fused_weights()
            rows = torch.randn((2 * n, w, c), generator=g, device=dev).to(dtype)
            kern = lambda: fb.fused_basic_attn_block(rows, n, wts, heads)  # noqa: E731
            if args.trace:
                import ctypes
                lib = _build.library("fused_basic_attn_block")
                buf = (ctypes.c_ulonglong * (1024 * 16))()
                kern()
                torch.cuda.synchronize()
                lib.s2m2_fused_block_trace(buf)  # zero the sums
                kern()
                torch.cuda.synchronize()
                lib.s2m2_fused_block_trace(buf)
                sums = np.array(buf, dtype=np.float64).reshape(1024, 16)
                sums = sums[sums[:, 2] > 0]
                names = ("consumer_wait_full", "producer_wait_empty", "total", "attention",
                         "phase1_ln_qkv", "proj", "ln2", "ffn", "epilogues", "layer_norms",
                         "q_loads", "attn_k_wait", "attn_scores", "attn_softmax",
                         "attn_v_wait", "attn_pv")
                emit({"probe": "dblock_trace", "shape": [n, w, c, heads],
                      "dtype": str(dtype).split(".")[1], "blocks": len(sums),
                      "share_of_total": {k: float(sums[:, i].sum() / sums[:, 2].sum())
                                         for i, k in enumerate(names)},
                      "total_mcycles_mean": float(sums[:, 2].mean() / 1e6)}, args.out)
                continue
            got = kern()
            ref = torch.cat(fb.fused_basic_attn_block_plain(rows[:n], rows[n:], wts, heads))
            plan = getattr(fb, "plan", None)
            emit({"probe": "dblock", "label": args.label, "shape": [n, w, c, heads],
                  "dtype": str(dtype).split(".")[1],
                  "plan": plan(w, c, c, heads, dtype)._asdict() if plan else None,
                  "max_abs_err": float((got.float() - ref.float()).abs().max()),
                  "max_abs_ref": float(ref.float().abs().max()),
                  "ms": time_ms(kern, n=10, warmup=2, reps=5),
                  "device_ms": device_us(kern, n=5) / 1e3,
                  "unfused_ms": time_ms(lambda: b.forward_rows(rows), n=10, warmup=2, reps=5),
                  "device": torch.cuda.get_device_name(0)}, args.out)


OT_SHAPES = ((1, 256, 304, 128), (1, 256, 304, 384), (1, 128, 608, 128))


OT_STAGES = ("correlation_epilogue", "column_items", "column_local_merge", "cluster_barrier",
             "column_cluster_merge", "row_sweep", "final_pass", "exit_wait",
             "correlation_main_loop")


def _ot_clusters(plan):
    """How many clusters of `plan` fit on the card at once, or None."""
    import ctypes
    from s2m2_torch.ops import _build
    lib = _build.library("sinkhorn_ot")
    if plan is None or plan.route != "resident" or not hasattr(lib, "s2m2_ot_max_clusters"):
        return None
    out = ctypes.c_int(0)
    _build.check(lib, lib.s2m2_ot_max_clusters(1, plan.cluster, plan.smem, ctypes.byref(out)),
                 "s2m2_ot_max_clusters")
    return out.value


def cmd_ot(args):
    import ctypes
    import torch
    from s2m2_torch.ops import _build
    if args.trace:  # a measurement build of kernel C, in its own directory
        _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DS2M2_C_TRACE=1")
        _build.BUILD_DIR = _build.BUILD_DIR.parent / "s2m2_torch_trace"
    from s2m2_torch.models.layers import layer_norm
    from s2m2_torch.ops import sinkhorn
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    plan = getattr(sinkhorn, "plan", None)
    for shape in OT_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            f0, f1 = (layer_norm(torch.randn(shape, generator=g, device=dev)).to(dtype)
                      for _ in range(2))
            kern = lambda: sinkhorn.fused_correlation_ot(f0, f1)  # noqa: E731
            plain = lambda: sinkhorn.fused_correlation_ot_plain(f0, f1)  # noqa: E731
            p = plan(shape[2], shape[3], dtype, True) if plan else None
            if args.trace:
                lib = _build.library("sinkhorn_ot")
                buf = (ctypes.c_ulonglong * 16)()
                kern()
                torch.cuda.synchronize()
                _build.check(lib, lib.s2m2_ot_trace(buf), "s2m2_ot_trace")  # zero the sums
                kern()
                torch.cuda.synchronize()
                _build.check(lib, lib.s2m2_ot_trace(buf), "s2m2_ot_trace")
                ctas = max(1, buf[15])
                total = sum(buf[:len(OT_STAGES)])
                emit({"probe": "ot_trace", "shape": list(shape),
                      "dtype": str(dtype).split(".")[1], "plan": p._asdict(), "ctas": buf[15],
                      "cycles_per_cta": {k: buf[i] / ctas for i, k in enumerate(OT_STAGES)},
                      "share": {k: buf[i] / max(1, total) for i, k in enumerate(OT_STAGES)},
                      "device": torch.cuda.get_device_name(0)}, args.out)
                continue
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got = kern()
            torch.cuda.synchronize()
            added = torch.cuda.max_memory_allocated() - base
            ref = plain()
            emit({"probe": "ot", "label": args.label, "shape": list(shape),
                  "dtype": str(dtype).split(".")[1],
                  "plan": p._asdict() if p else None, "max_active_clusters": _ot_clusters(p),
                  "max_abs_err": {k: float((a.float() - b.float()).abs().max())
                                  for k, a, b in (("prob", got[0], ref[0]),
                                                  ("cv", got[1], ref[1]))},
                  "max_abs_ref": {"prob": float(ref[0].float().abs().max()),
                                  "cv": float(ref[1].float().abs().max())},
                  "ms": time_ms(kern), "ms_single": time_ms(kern, reps=1),
                  "device_ms": device_us(kern, n=10) / 1e3,
                  "plain_ms": time_ms(plain, n=5, warmup=1, reps=1),
                  "plain_device_ms": device_us(plain, n=3) / 1e3,
                  "call_bytes": added, "device": torch.cuda.get_device_name(0)}, args.out)
            del got, ref


def _swapped(route):
    """A context in which `route` runs its plain version on CUDA tensors."""
    import contextlib
    import torch
    import torch.nn.functional as F
    from s2m2_torch.models import matching
    from s2m2_torch.ops import flash_attention as fa
    from s2m2_torch.ops import int8_gemm as ig
    from s2m2_torch.ops import sinkhorn

    def packed_plain(q, k, v):
        h = q.shape[0] // 2
        return torch.cat(fa.scanline_cross_attention_plain(q[:h], k[:h], v[:h],
                                                           q[h:], k[h:], v[h:]))

    def gemm_plain(a, w, w_scale=None, s_x=1.0, bias=None, out_dtype=torch.bfloat16,
                   out=None, m_base=0, conv=None):
        if conv is not None and tuple(conv) == (1, 1, 1, 1, 0, 0):
            a, conv = a.reshape(-1, a.shape[3]), None
        y = ig.int8_gemm_plain(a, w, w_scale, s_x, bias, out_dtype, conv)
        if out is None:
            return y
        ig._write_nchw(out, y, m_base)
        return out

    conv2d = F.conv2d

    def conv_f32(x, w, b=None, *args, **kwargs):
        if x.dtype != torch.bfloat16:
            return conv2d(x, w, b, *args, **kwargs)
        return conv2d(x.float(), w.float(), None if b is None else b.float(), *args,
                      **kwargs).to(torch.bfloat16)

    table = {"A": [(fa, "scanline_attention", fa.scanline_attention_plain)],
             "B": [(fa, "scanline_cross_attention_packed", packed_plain)],
             "C": [(matching, "fused_correlation_ot", sinkhorn.fused_correlation_ot_plain)],
             "E_gemm": [(ig, "int8_gemm", gemm_plain)],
             "cudnn_conv_f32": [(F, "conv2d", conv_f32)]}

    @contextlib.contextmanager
    def ctx():
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in table.get(route, [])]
        for mod, name, fn in table.get(route, []):
            setattr(mod, name, fn)
        try:
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
    return ctx()


def cmd_drift(args):
    import torch
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.runtime.engine import StereoEngine
    path = Path(__file__).resolve().parents[2] / "tests" / "golden" / "s2m2_c32_ntr1_neg_up.npz"
    with np.load(path) as z:
        meta = list(z["__meta"])
        img0 = np.transpose(z["__img0"], (0, 2, 3, 1))
        img1 = np.transpose(z["__img1"], (0, 2, 3, 1))
        ref = np.transpose(z["__disp"], (0, 2, 3, 1))
    cfg = ModelConfig(feature_channels=int(meta[0]), num_transformer=int(meta[1]),
                      refine_iter=int(meta[2]), use_positivity=bool(meta[3]),
                      output_upsample=bool(meta[4]))
    for precision in ("int8", "int8r"):
        for route in ("none", "A", "B", "C", "E_gemm", "cudnn_conv_f32"):
            with _swapped(route):
                eng = StereoEngine(cfg, checkpoint=str(path), precision=precision,
                                   device="cuda")
                eng.calibrate(img0, img1)
                disp = eng.forward_padded(img0, img1)[0].cpu().numpy()
            emit({"probe": "drift", "fixture": path.name, "precision": precision,
                  "plain_route": route, "epe_px": float(np.abs(disp - ref).mean()),
                  "device": torch.cuda.get_device_name(0)}, args.out)


# F's kernels in a profile: the first version's; the redesign's prologue,
# attention kernel and one-tile fused kernel
F_KERNELS = ("int8_attention_kernel", "int8_attn_quantize_kernel", "int8_attn_kernel",
             "int8_attn_fused_kernel")


def _f_device_ms(prof):
    """(all device ms, F's device ms) of a profile."""
    import torch
    evs = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in evs) / 1e3,
            sum(e.self_device_time_total for e in evs
                if any(k in e.key for k in F_KERNELS)) / 1e3)


def _f_by_kernel(fn, n=10):
    """Device ms a call of each of F's kernels under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for k in F_KERNELS if k in e.key), "other")
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / n
    return out


def _f_occupancy(pl, dtype):
    """Blocks of F's attention kernel an SM holds under plan `pl`, or None
    where the checkout's library has no such query."""
    import ctypes
    import torch
    from s2m2_torch.ops import _build
    lib = _build.library("int8_attention")
    if not hasattr(lib, "s2m2_int8_attention_occupancy"):
        return None
    out = ctypes.c_int(0)
    _build.check(lib, lib.s2m2_int8_attention_occupancy(
        int(dtype == torch.bfloat16), pl.dch, int(pl.route == "fused"), pl.smem,
        ctypes.byref(out)), "s2m2_int8_attention_occupancy")
    return out.value


# g_trace's slots in F's trace build (csrc/int8_attention.cu, S2M2_F_TRACE)
F_TRACE = ("total", "q_wait", "p1_full_wait", "p1_scores", "p1_max", "p2_full_wait",
           "p2_scores_pv_wait", "p2_probabilities", "p2_pv_issue", "epilogue", "units",
           "producer_empty_wait", "producer_issue")


def _f_trace(fn):
    """The cycles of one call of `fn` in each stage of F's trace build,
    summed over the units, and their share of the units' total."""
    import ctypes
    import torch
    from s2m2_torch.ops import _build
    lib = _build.library("int8_attention")
    buf = (ctypes.c_ulonglong * 16)()
    fn()
    torch.cuda.synchronize()
    lib.s2m2_int8_attention_trace(buf)  # zero the sums
    fn()
    torch.cuda.synchronize()
    lib.s2m2_int8_attention_trace(buf)
    sums = dict(zip(F_TRACE, (float(x) for x in buf)))
    units = max(sums["units"], 1.0)
    return {"units": sums["units"], "mcycles_per_unit": sums["total"] / units / 1e6,
            "share_of_total": {k: v / max(sums["total"], 1.0) for k, v in sums.items()
                               if k not in ("total", "units")}}


def _f_dispatch(ia, dev):
    """Host us of each step of F's wrapper at S's smallest shape, (64, 76,
    64) bf16: the whole wrapper, the direct launch, and its parts."""
    import torch
    from s2m2_torch.ops import _build
    from s2m2_torch.ops._grad import refuse_grad
    shape, dtype = (64, 76, 64), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(3))
    sc = [float(x.float().abs().max()) / 127 for x in (q, k, v)]
    dev = q.device  # with its index
    pl = ia.plan(*shape[:2], shape[1], shape[2], dtype)
    out = torch.empty_like(q)
    entry = _build.entry("int8_attention", *ia._ENTRY)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0, pl.workspace,
            *shape[:2], shape[1], shape[2], *ia.scales(*sc, shape[2]), 1, pl.stages)
    steps = {"wrapper": lambda: ia.int8_attention(q, k, v, *sc),
             "direct_launch": lambda: ia._kernel(q, k, v, *sc),
             "c_entry_via_call": lambda: _build.call(entry, dev, "int8_attention", *args),
             "c_entry_bare": lambda: entry[1](*args, torch._C._cuda_getCurrentRawStream(
                 dev.index)),
             "check": lambda: ia.check(q, k, v),
             "via_op": lambda: _build.via_op(q),
             "refuse_grad": lambda: refuse_grad("int8_attention", q, k, v),
             "plan": lambda: ia.plan(*shape[:2], shape[1], shape[2], dtype),
             "scales": lambda: ia.scales(*sc, shape[2]),
             "empty_like": lambda: torch.empty_like(q),
             "workspace": lambda: ia._workspace(dev, pl.workspace)}
    return {"shape": list(shape), "host_us": {k: host_us(fn, n=300) for k, fn in steps.items()}}


def cmd_fattn(args):
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    import s2m2_torch
    from s2m2_torch.config import get_config
    from s2m2_torch.ops import _build
    if args.trace:  # a measurement build of kernel F, in its own directory
        _build.NVCC_FLAGS = (*_build.NVCC_FLAGS, "-DS2M2_F_TRACE=1")
        _build.BUILD_DIR = _build.BUILD_DIR.parent / "s2m2_torch_trace"
    from s2m2_torch.ops import int8_attention as ia
    dev = torch.device("cuda")
    plan = getattr(ia, "plan", None)
    name = torch.cuda.get_device_name(0)
    for model in filter(None, args.models.split(",")):
        shapes = chip_smoke.int8_attn_shapes(get_config(model), H, W)
        for shape, per_forward in shapes.items():
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[1]
                g = torch.Generator(device=dev).manual_seed(0)
                q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype) * f
                           for f in (1.0, 1.5, 2.0))
                sc = [float(x.float().abs().max()) / 127 for x in (q, k, v)]
                kern = lambda: ia.int8_attention(q, k, v, *sc)  # noqa: E731
                if args.trace:
                    emit({"probe": "fattn_trace", "model": model, "shape": list(shape),
                          "dtype": dn, **_f_trace(kern)}, args.out)
                    continue
                res = ia.agreement(kern(), q, k, v, *sc)
                rec = {"probe": "fattn", "label": args.label, "package": s2m2_torch.__file__,
                       "model": model, "shape": list(shape), "dtype": dn,
                       "per_forward": per_forward,
                       "ms": time_ms(kern, n=10, warmup=3, reps=10),
                       "device_ms": device_us(kern, n=10) / 1e3,
                       "device_by_kernel_ms": _f_by_kernel(kern),
                       "host_us": host_us(kern, n=100),
                       "bound_ms": max(chip_smoke.bound("int8_attention", shape, dn)),
                       "agreement_ok": res["ok"], "flipped_share": res["flipped_share"],
                       "max_abs_err": res["max_abs_err"], "device": name}
                if plan is not None:
                    pl = plan(shape[0], shape[1], shape[1], shape[2], dtype)
                    rec["plan"] = pl._asdict()
                    rec["blocks_per_sm"] = _f_occupancy(pl, dtype)
                emit(rec, args.out)
    if plan is not None and not args.trace:
        emit({"probe": "fattn_dispatch", "label": args.label, "device": name,
              **_f_dispatch(ia, dev)}, args.out)
    if not args.forward:
        return
    from s2m2_torch.runtime.engine import StereoEngine
    _build.build_all()
    rng = np.random.default_rng(0)
    left, right = _pair(rng, 16)
    eng = StereoEngine("S", precision="int8", int8_attn=True, seed=0)
    eng.run(left, right)  # calibrates
    ms = float(eng.run(left, right)[4])
    _build.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.forward_padded(left[None], right[None])
        torch.cuda.synchronize()
    busy, f_ms = _f_device_ms(prof)
    emit({"probe": "fattn_forward", "label": args.label, "package": s2m2_torch.__file__,
          "model": "S", "precision": "int8", "int8_attn": True, "request_ms": ms,
          "device_busy_ms": busy if busy > 0 else "not measured",
          "f_device_ms": f_ms if busy > 0 else "not measured",
          "f_launches": _build.launch_counts["int8_attention"], "device": name}, args.out)


def main():
    # the checkout this file lies in, after PYTHONPATH (which may name an
    # older checkout to measure instead)
    sys.path.append(str(Path(__file__).resolve().parents[2]))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("fill", "dispatch", "sweep", "int8", "drift"):
        sub.add_parser(name).add_argument("--out")
    ot = sub.add_parser("ot")
    ot.add_argument("--label", default="")
    ot.add_argument("--trace", action="store_true",
                    help="kernel C built with S2M2_C_TRACE: the cycles of its stages")
    ot.add_argument("--out")
    dbl = sub.add_parser("dblock")
    dbl.add_argument("--label", default="")
    dbl.add_argument("--trace", action="store_true",
                     help="kernel D built with S2M2_D_TRACE: the cycles of its stages")
    dbl.add_argument("--out")
    req = sub.add_parser("requests")
    req.add_argument("--model", default="S")
    req.add_argument("--precision", default="bf16,int8a,int8r")
    req.add_argument("--n", type=int, default=16)
    req.add_argument("--label", default="")
    req.add_argument("--via-ops", action="store_true",
                     help="every kernel call through its custom op (this checkout only)")
    req.add_argument("--out")
    sens = sub.add_parser("sensitivity")
    sens.add_argument("--seeds", type=int, default=4)
    sens.add_argument("--out")
    fat = sub.add_parser("fattn")
    fat.add_argument("--label", default="")
    fat.add_argument("--models", default="S,XL")
    fat.add_argument("--forward", action="store_true",
                     help="also one traced S int8 int8_attn forward")
    fat.add_argument("--trace", action="store_true",
                     help="kernel F built with S2M2_F_TRACE: the cycles of its stages")
    fat.add_argument("--out")
    cal = sub.add_parser("calib")
    cal.add_argument("--n", type=int, default=20)
    cal.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if args.cmd in ("fill", "dispatch", "sweep"):
        with torch.inference_mode():
            {"fill": cmd_fill, "dispatch": cmd_dispatch, "sweep": cmd_sweep}[args.cmd](args)
    elif args.cmd == "int8":
        with torch.inference_mode():
            cmd_int8(args)
    elif args.cmd == "drift":
        cmd_drift(args)
    elif args.cmd == "dblock":
        with torch.inference_mode():
            cmd_dblock(args)
    elif args.cmd == "ot":
        with torch.inference_mode():
            cmd_ot(args)
    elif args.cmd == "fattn":
        with torch.inference_mode():
            cmd_fattn(args)
    elif args.cmd == "calib":
        cmd_calib(args)
    elif args.cmd == "sensitivity":
        with torch.inference_mode():
            cmd_sensitivity(args)
    else:
        cmd_requests(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
