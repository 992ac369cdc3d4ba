"""Offline int8 calibration: a reusable activation-scale cache, from
`s2m2_tpu/tools/calibrate.py`.

An int8 engine needs per-site static activation scales (models/quant.py).
Serving need not pay the calibration pass in every process: this tool runs
it once over representative frames and saves the scale vector, the `.npy`
that `StereoEngine.load_calibration` reads (the JAX engine's files load
too, when the site counts agree).

  python -m s2m2_torch.tools.calibrate --model S --checkpoint CH128NTR1.npz \\
      --images left1.png right1.png left2.png right2.png --out s_calib.npy

  eng = StereoEngine("S", checkpoint=..., precision="int8")
  eng.load_calibration("s_calib.npy")   # no calibration pass at serve time

With no --images the CLI calibrates on the engine's benchmark pair
(`StereoEngine._benchmark_calib_pair`: S2M2_CALIB_PAIR, or the seeded
synthetic scene).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def calibrate_engine(engine, image_pairs=None, max_hw=512):
    """Run the calibration pass over (left, right) pairs, each decimated to
    at most max_hw px; scales accumulate by elementwise max. With no pairs,
    one synthetic uniform-noise pair (default_rng(0), (1, 480, 640, 3)).
    Returns the scale vector."""
    from ..utils.image import image_pad

    if not image_pairs:
        rng = np.random.default_rng(0)
        shape = (1, 480, 640, 3)
        image_pairs = [(rng.uniform(0, 255, shape).astype(np.float32),
                        rng.uniform(0, 255, shape).astype(np.float32))]
    scales = None
    for left, right in image_pairs:
        left = np.asarray(left, np.float32)
        right = np.asarray(right, np.float32)
        if left.ndim == 3:
            left, right = left[None], right[None]
        step = max(1, int(np.ceil(max(left.shape[1:3]) / max_hw)))
        left, right = left[:, ::step, ::step], right[:, ::step, ::step]
        scales = engine.calibrate(image_pad(left), image_pad(right))
    return scales


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="S", choices=["S", "M", "L", "XL"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--images", nargs="*", default=None,
                    help="alternating left/right image paths")
    ap.add_argument("--out", required=True)
    ap.add_argument("--max_hw", type=int, default=512)
    ap.add_argument("--num_refine", type=int, default=3,
                    help="must match the serving engine's refine_iter "
                         "(the site count depends on it)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..runtime.engine import StereoEngine
    from ..utils.image import read_images

    pairs = []
    paths = args.images
    if paths:
        if len(paths) % 2:
            ap.error("--images takes an even number of paths (L R L R ...)")
        for i in range(0, len(paths), 2):
            pairs.append(read_images(paths[i], paths[i + 1]))

    eng = StereoEngine(args.model, checkpoint=args.checkpoint, precision="int8",
                       refine_iter=args.num_refine, device=args.device)
    if not pairs:
        pairs = [tuple(x[0] for x in eng._benchmark_calib_pair())]
    calibrate_engine(eng, pairs, max_hw=args.max_hw)
    eng.save_calibration(args.out)
    print(f"saved {len(eng.quant_scales)} scales -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
