"""Measurements on a CUDA card that chip_smoke.py does not make.

    python3 s2m2_torch/tools/chip_probe.py fill [--out FILE]
    python3 s2m2_torch/tools/chip_probe.py dispatch [--out FILE]
    python3 s2m2_torch/tools/chip_probe.py sweep [--out FILE]
    python3 s2m2_torch/tools/chip_probe.py requests --model S \
        --precision bf16,int8a,int8r --n 16 [--label NAME] [--out FILE]

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
2D-block shape, beside the whole wrapper and SDPA's call.

`sweep`: kernel A's device time in bf16 for a few instances per padded D
(`SWEEP`) at the model's shapes, beside SDPA's and the compiled instance's.

`requests`: for each precision in turn, one StereoEngine (seeded random
weights) serving `--n` requests on 1216x1024 pairs after one warm-up
request (which calibrates an int8 engine), printing every request's ms.
It uses only the engine's public API, so it also runs against an older
checkout of the package:
`PYTHONPATH=<checkout> python3 s2m2_torch/tools/chip_probe.py requests ...`.

Every result is one JSON line on stdout (and appended to `--out`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

H, W = 1024, 1216


def emit(obj, out):
    line = json.dumps(obj)
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
    fa._entry.cache_clear()
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
    bf16, beside the whole wrapper and SDPA's call."""
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
    }
    emit({"probe": "dispatch", "shape": [8, 1216, 32], "dtype": "bfloat16",
          "host_us": {name: host_us(f, n=1000) for name, f in steps.items()}}, args.out)


def _pair(rng, disp):
    base = rng.uniform(0, 255, (H // 8 + 1, W // 8 + 1, 3)).astype(np.float32)
    left = np.repeat(np.repeat(base, 8, 0), 8, 1)[:H, :W]
    right = np.roll(left, -disp, axis=1)
    return left, right


def cmd_requests(args):
    import torch
    import s2m2_torch
    from s2m2_torch.ops import _build
    from s2m2_torch.runtime.engine import StereoEngine
    _build.build_all()
    rng = np.random.default_rng(0)
    pairs = [_pair(rng, 16 + 8 * (i % 8)) for i in range(8)]
    for precision in args.precision.split(","):
        eng = StereoEngine(args.model, precision=precision, seed=0)
        t0 = time.perf_counter()
        eng.run(*pairs[0])  # warm-up; calibrates an int8 engine
        warm_s = time.perf_counter() - t0
        ms = [float(eng.run(*pairs[i % len(pairs)])[4]) for i in range(args.n)]
        emit({"probe": "requests", "label": args.label, "package": s2m2_torch.__file__,
              "model": args.model, "precision": precision, "requests": args.n,
              "warmup_s": warm_s, "ms_per_request": ms, "median_ms": float(np.median(ms)),
              "mean_ms": float(np.mean(ms))}, args.out)
        del eng
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("fill", "dispatch", "sweep"):
        sub.add_parser(name).add_argument("--out")
    req = sub.add_parser("requests")
    req.add_argument("--model", default="S")
    req.add_argument("--precision", default="bf16,int8a,int8r")
    req.add_argument("--n", type=int, default=16)
    req.add_argument("--label", default="")
    req.add_argument("--out")
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
    else:
        cmd_requests(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
