"""Export a (variant, resolution, precision) .pt2 artifact and verify it by
reloading it and running a random pair (reference: demo/export_onnx.py; the
JAX package's demo/export_stablehlo.py).

    python -m s2m2_torch.demo.export [--model_type S] [--height 480]
        [--width 640] [--precision bf16|fp32|int8] [--num_refine 3]
        [--checkpoint FILE] [--out_dir artifacts] [--verify] [--device cuda]

The resolution is padded to multiples of 32, as the engine pads. bf16 and
fp32 artifacts embed the weights (every parameter cast to the precision);
an int8 artifact is a calibrated int8 engine's program (static scales
baked in, calibrated on a seeded synthetic pair at the export resolution)
and takes its prequantized weights as an argument. It traces on the card
unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_type", default="S", choices=["S", "M", "L", "XL"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--precision", default="bf16", choices=["bf16", "fp32", "int8"])
    ap.add_argument("--num_refine", type=int, default=3)
    ap.add_argument("--out_dir", default="artifacts")
    ap.add_argument("--verify", action="store_true",
                    help="reload the artifact and run a random pair")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch
    from .. import config
    from ..tools import export as ex

    cfg = config.get_config(args.model_type, refine_iter=args.num_refine)
    h = -(-args.height // 32) * 32
    w = -(-args.width // 32) * 32
    state = None
    if args.precision == "int8":
        from ..runtime.engine import StereoEngine
        from ..train.data import _random_scene
        eng = StereoEngine(cfg, checkpoint=args.checkpoint, precision="int8",
                           device=args.device)
        left, right, _ = _random_scene(np.random.default_rng(0), h, w, max(8, w // 8))
        eng.calibrate(left[None], right[None])
        blob = ex.export_quantized_forward(eng, h, w)
        state = ex.quantized_state(eng)
    else:
        from ..models.init import init_params
        from ..tools.convert import load_checkpoint, tolerant_merge
        params = init_params(cfg, seed=0)
        if args.checkpoint:
            params = tolerant_merge(params, load_checkpoint(args.checkpoint))
        dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
        blob = ex.export_forward(params, cfg, h, w, compute_dtype=dtype, device=args.device)
    path = os.path.join(args.out_dir, ex.artifact_name(cfg, h, w, args.precision))
    ex.save_artifact(path, blob)
    print(f"exported {len(blob) / 1e6:.1f} MB -> {path}")

    if args.verify:
        fn = ex.load_artifact(path, device=args.device)
        rng = np.random.default_rng(0)
        img = torch.from_numpy(rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)).to(
            args.device)
        disp = fn(*(() if state is None else (state,)), img, img)[0]
        if disp.shape != (1, h, w, 1) or not bool(torch.isfinite(disp).all()):
            print(f"verify: disp {tuple(disp.shape)} not finite (1, {h}, {w}, 1)")
            return 1
        print(f"verify: disp {tuple(disp.shape)} range "
              f"[{float(disp.min()):.2f}, {float(disp.max()):.2f}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
