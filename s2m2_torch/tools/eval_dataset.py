"""Dataset evaluation runner: EPE / bad-N / D1 / confidence-AUC over a
directory of Middlebury-style scenes, on the port's engine (a copy of
s2m2_tpu/tools/eval_dataset.py; the reference has no eval harness,
SURVEY.md §5.5).

Expected layout per scene (Middlebury V3 / ETH3D two-view convention):
  <scene>/im0.png  <scene>/im1.png  <scene>/disp0GT.pfm  [mask0nocc.png]
  <scene>/calib.txt (optional, for ndisp)

Usage:
  python -m s2m2_torch.tools.eval_dataset --root DIR --model S [--checkpoint X]

A scene whose files cannot be read is reported and skipped; an error of the
engine stops the run.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ..utils.metrics import evaluate_pair


def read_pfm(path):
    """Middlebury PFM disparity reader."""
    with open(path, "rb") as f:
        header = f.readline().decode().rstrip()
        if header not in ("Pf", "PF"):
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().decode().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().decode().rstrip())
        data = np.fromfile(f, "<f" if scale < 0 else ">f")
    channels = 3 if header == "PF" else 1
    img = data.reshape(h, w, channels) if channels == 3 else data.reshape(h, w)
    return np.flipud(img).copy()


def _read_gray(path):
    """A grayscale PNG as uint8 (H, W): cv2 where it is installed, else PIL."""
    try:
        import cv2
    except ImportError:
        from PIL import Image
        return np.asarray(Image.open(path).convert("L"))
    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise OSError(f"cannot read {path}")
    return img


def eval_scene(engine, scene_dir, downscale=1):
    from ..utils.image import read_images
    paths = [os.path.join(scene_dir, n) for n in ("im0.png", "im1.png")]
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    left, right = read_images(*paths)
    gt = read_pfm(os.path.join(scene_dir, "disp0GT.pfm"))
    valid = np.isfinite(gt) & (gt > 0)
    nocc_path = os.path.join(scene_dir, "mask0nocc.png")
    if os.path.exists(nocc_path):
        valid = valid & (_read_gray(nocc_path) == 255)
    if downscale > 1:
        left = left[::downscale, ::downscale]
        right = right[::downscale, ::downscale]
        gt = gt[::downscale, ::downscale] / downscale
        valid = valid[::downscale, ::downscale]

    disp, occ, conf, score, ms = engine.run(left, right)
    m = evaluate_pair(disp, gt, conf=conf, valid=valid)
    m["conf_score"] = score
    m["runtime_ms"] = ms
    return m


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--model", default="S", choices=["S", "M", "L", "XL"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--precision", default="bf16", choices=["bf16", "fp32", "int8", "int8a", "int8r"])
    ap.add_argument("--num_refine", type=int, default=3)
    ap.add_argument("--downscale", type=int, default=1)
    ap.add_argument("--out", default=None, help="write JSON results here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    scenes = sorted(d for d in glob.glob(os.path.join(args.root, "*"))
                    if os.path.exists(os.path.join(d, "disp0GT.pfm")))
    if not scenes:
        print(f"no scenes with disp0GT.pfm under {args.root}")
        return 1

    from ..runtime.engine import StereoEngine
    engine = StereoEngine(args.model, checkpoint=args.checkpoint,
                          precision=args.precision,
                          refine_iter=args.num_refine, device=args.device)

    results = {}
    for scene in scenes:
        name = os.path.basename(scene)
        try:
            results[name] = eval_scene(engine, scene, args.downscale)
            print(f"{name}: epe={results[name]['epe']:.3f} "
                  f"bad2={results[name]['bad_2.0']:.4f}")
        except (OSError, ValueError) as e:  # unreadable scene files
            print(f"{name}: FAILED ({e})")

    if results:
        agg = {k: float(np.mean([r[k] for r in results.values()]))
               for k in next(iter(results.values()))}
        print("\nmean:", json.dumps(agg, indent=2))
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"scenes": results, "mean": agg}, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
