"""Booster 3D demo (reference: demo/visualize_3d_booster.py; the JAX
package's demo/visualize_3d_booster.py): OpenCV-XML calib (proj_matL /
baselineLR), inference at half the input's size, point cloud.

    python -m s2m2_torch.demo.visualize_3d_booster [--data_dir DIR]
        [--model_type XL] [--precision bf16] [--out booster_cloud.ply]
        [--html viewer.html] [--device cuda]

DIR holds im0.png, im1.png and calib.xml; without --data_dir the demo
writes a synthesized 2432x2048 scene and its calib.xml (`demo/_scenes.py`)
into a temporary directory and reads them back. The calib is read and the
pair halved without OpenCV (`utils.filestorage`, `utils.image.downscale_half`,
both equal to OpenCV's). It runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def read_booster_calib(calib_path):
    """proj_matL 3x3 + baselineLR; doffs = 0
    (reference: demo/visualize_3d_booster.py:54-61)."""
    from ..utils.filestorage import read_filestorage
    nodes = read_filestorage(calib_path, ("proj_matL", "baselineLR"))
    if len(nodes) != 2:
        raise ValueError(f"{calib_path}: needs proj_matL and baselineLR, found "
                         f"{sorted(nodes)}")
    return {"cam0": nodes["proj_matL"], "baseline": float(nodes["baselineLR"]),
            "doffs": 0.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data_dir", default=None, help="default: synthesized")
    ap.add_argument("--model_type", default="XL", choices=["S", "M", "L", "XL"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--num_refine", type=int, default=3)
    ap.add_argument("--precision", default="bf16",
                    choices=["bf16", "fp32", "int8", "int8a", "int8r"])
    ap.add_argument("--out", default="booster_cloud.ply")
    ap.add_argument("--html", default=None,
                    help="also write a self-contained interactive WebGL "
                         "viewer (open in any browser; no dependencies)")
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..runtime.engine import StereoEngine
    from ..utils.image import downscale_half, read_images
    from ..utils.pointcloud import get_pointcloud, save_html_viewer, save_ply, \
        show_pointcloud
    from ..utils.vis import validity_mask
    from . import _scenes

    with tempfile.TemporaryDirectory() as tmp:
        if args.data_dir is None:
            _scenes.write_defaults("booster", tmp)
            args.data_dir = tmp
        calib = read_booster_calib(os.path.join(args.data_dir, "calib.xml"))
        left, right = read_images(os.path.join(args.data_dir, "im0.png"),
                                  os.path.join(args.data_dir, "im1.png"))
    # 2x downsample like the reference (demo:76-77)
    left, right = downscale_half(left), downscale_half(right)

    eng = StereoEngine(args.model_type, checkpoint=args.checkpoint,
                       precision=args.precision, refine_iter=args.num_refine,
                       use_positivity=True, device=args.device)
    disp, occ, conf, score, ms = eng.run(left, right, n_repeat=5)
    print(f"confidence score: {score:.4f}, runtime {ms:.1f} ms "
          f"({1e3 / ms:.1f} FPS)")

    valid = validity_mask(conf, occ)
    disp_f = disp.copy()
    disp_f[~valid] = -1
    pts, cols = get_pointcloud(left, disp_f, calib, depth_trunc=3.0,
                               intrinsic_scale=0.5)
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
