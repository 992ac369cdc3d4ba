"""Middlebury 3D demo (reference: demo/visualize_3d_middlebury.py; the JAX
package's demo/visualize_3d_middlebury.py): parse calib.txt, run stereo,
back-project to a point cloud (PLY, and optionally a WebGL viewer page).

    python -m s2m2_torch.demo.visualize_3d_middlebury [--data_dir DIR]
        [--model_type L] [--precision bf16] [--out middlebury_cloud.ply]
        [--html viewer.html] [--device cuda]

DIR holds im0.png, im1.png and calib.txt; without --data_dir the demo
writes a synthesized scene (`demo/_scenes.py`) into a temporary directory
and reads it back. It runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data_dir", default=None, help="default: synthesized")
    ap.add_argument("--model_type", default="L", choices=["S", "M", "L", "XL"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--num_refine", type=int, default=3)
    ap.add_argument("--precision", default="bf16",
                    choices=["bf16", "fp32", "int8", "int8a", "int8r"])
    ap.add_argument("--downscale", type=int, default=1)
    ap.add_argument("--out", default="middlebury_cloud.ply")
    ap.add_argument("--html", default=None,
                    help="also write a self-contained interactive WebGL "
                         "viewer (open in any browser; no dependencies)")
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..runtime.engine import StereoEngine
    from ..utils.calib import read_middlebury_calib
    from ..utils.image import read_images
    from ..utils.pointcloud import get_pointcloud, save_html_viewer, save_ply, \
        show_pointcloud
    from . import _scenes

    with tempfile.TemporaryDirectory() as tmp:
        if args.data_dir is None:
            _scenes.write_defaults("middlebury", tmp)
            args.data_dir = tmp
        calib = read_middlebury_calib(os.path.join(args.data_dir, "calib.txt"))
        left, right = read_images(os.path.join(args.data_dir, "im0.png"),
                                  os.path.join(args.data_dir, "im1.png"))
    if args.downscale > 1:
        left = left[::args.downscale, ::args.downscale]
        right = right[::args.downscale, ::args.downscale]

    eng = StereoEngine(args.model_type, checkpoint=args.checkpoint,
                       precision=args.precision, refine_iter=args.num_refine,
                       use_positivity=True, device=args.device)
    disp, occ, conf, score, ms = eng.run(left, right)
    print(f"confidence score: {score:.4f}, runtime {ms:.1f} ms")

    disp_full = disp * args.downscale  # disparity scales with resolution
    pts, cols = get_pointcloud(left, disp_full, calib,
                               intrinsic_scale=0.5 / args.downscale)
    save_ply(args.out, pts, cols)
    print(f"saved {len(pts)} points -> {args.out}")
    if args.html:
        save_html_viewer(args.html, pts, cols)
        print(f"interactive viewer -> {args.html}")
    if args.show:
        show_pointcloud(pts, cols)
    return 0


if __name__ == "__main__":
    sys.exit(main())
