"""Frames per second of the port on one card; prints ONE JSON line.

    python -m s2m2_torch.tools.bench [--model XL] [--precision bf16]
        [--fused_block] [--width 1216] [--height 1024] [--iters 5] [--batch 1]

`value` is `StereoEngine.benchmark`'s frames/s: CUDA events around `iters`
forwards (after 2 warm ones) on synthetic inputs at the padded resolution,
refine_iter 3, positivity on, seeded random weights. `vs_baseline` divides it
by the reference's TensorRT fp16 figure on an RTX 5090 for the same model and
resolution (`BASELINE_FPS`, a copy of bench.py's table, reference
README.md:63-122), null where the table has none. `name` and `power_limit_w`
are the card's, as nvidia-smi reports them: a card set below its maximum
power runs slower under load, so every figure travels with its limit.
The default precision is bf16; there is no "best precision" table for this
card yet. An int8 engine calibrates first, outside the timed forwards.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

BASELINE_FPS = {  # TensorRT fp16 on RTX 5090 (reference README.md:63-122)
    ("S", 640, 480): 124.0, ("S", 1216, 1024): 59.4, ("S", 2432, 2048): 7.3,
    ("M", 640, 480): 66.7, ("M", 1216, 1024): 18.3, ("M", 2432, 2048): 3.8,
    ("L", 640, 480): 46.6, ("L", 1216, 1024): 11.2, ("L", 2432, 2048): 2.4,
    ("XL", 640, 480): 26.6, ("XL", 1216, 1024): 6.4, ("XL", 2432, 2048): 1.4,
}


def card_name_and_power(index):
    """(name, power limit in W) of card `index`, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip().splitlines()
    name, power = (f.strip() for f in out[index].rsplit(",", 1))
    return name, float(power)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="XL", choices=["S", "M", "L", "XL"])
    ap.add_argument("--precision", default="bf16",
                    choices=["bf16", "fp32", "int8", "int8a", "int8r"])
    ap.add_argument("--fused_block", action="store_true")
    ap.add_argument("--width", type=int, default=1216)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batch", type=int, default=1)
    args = ap.parse_args(argv)

    import torch

    from ..runtime.engine import StereoEngine
    eng = StereoEngine(args.model, precision=args.precision, refine_iter=3,
                       use_positivity=True, fused_block=args.fused_block)
    # benchmark takes (height, width) of the padded frame; the reference's
    # "1216x1024" is width x height
    res = eng.benchmark(args.height, args.width, n_warmup=2, n_iter=args.iters,
                        batch=args.batch)
    fps = res["fps"]
    base = BASELINE_FPS.get((args.model, args.width, args.height))
    index = torch.cuda.current_device() if eng.device.index is None else eng.device.index
    name, power = card_name_and_power(index)
    route = "_fused" if args.fused_block else ""
    print(json.dumps({
        "metric": f"{args.model}_fps_{args.width}x{args.height}_{args.precision}{route}_per_gpu",
        "value": fps, "unit": "frames/s/gpu",
        "vs_baseline": fps / base if base else None,
        "name": name, "power_limit_w": power}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
