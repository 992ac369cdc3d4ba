"""2D stereo demo, the main entry (reference: demo/visualize_2d_simple.py;
the JAX package's demo/visualize_2d_simple.py): runs a stereo pair through
the engine, prints the confidence score and runtime, and saves (or shows)
the result panel.

    python -m s2m2_torch.demo.visualize_2d_simple [--left_path L.png
        --right_path R.png] [--model_type S] [--precision bf16]
        [--n_repeat 5] [--out result_2d.png] [--device cuda]

Without --left_path / --right_path it writes the synthesized 1216x1024
pair (`demo/_scenes.py`) into a temporary directory and reads it back. It
runs on the card unless `--device cpu` is given; reading PNGs and writing
the panel need neither OpenCV nor PIL (`--show` opens an OpenCV window).
"""
from __future__ import annotations

import argparse
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--left_path", default=None, help="default: synthesized")
    ap.add_argument("--right_path", default=None, help="default: synthesized")
    ap.add_argument("--model_type", default="S", choices=["S", "M", "L", "XL"])
    ap.add_argument("--checkpoint", default=None,
                    help=".npz (JAX layout) or .pth (reference) checkpoint")
    ap.add_argument("--num_refine", type=int, default=3)
    ap.add_argument("--allow_negative", action="store_true")
    ap.add_argument("--precision", default="bf16",
                    choices=["bf16", "fp32", "int8", "int8a", "int8r"])
    ap.add_argument("--downscale", type=int, default=1)
    ap.add_argument("--n_repeat", type=int, default=5)
    ap.add_argument("--out", default="result_2d.png")
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if (args.left_path is None) != (args.right_path is None):
        ap.error("give both --left_path and --right_path, or neither")

    from ..runtime.engine import StereoEngine
    from ..utils.image import read_images
    from ..utils.png import write_png
    from ..utils.vis import render_results_2d, show_results_2d
    from . import _scenes

    with tempfile.TemporaryDirectory() as tmp:
        if args.left_path is None:
            files = _scenes.write_defaults("2d", tmp)
            args.left_path, args.right_path = files["im0.png"], files["im1.png"]
        left, right = read_images(args.left_path, args.right_path)
    if args.downscale > 1:
        left = left[::args.downscale, ::args.downscale]
        right = right[::args.downscale, ::args.downscale]
    # crop to /32 multiples like the reference demo (demo:56-62)
    h, w = left.shape[:2]
    left = left[: h // 32 * 32, : w // 32 * 32]
    right = right[: h // 32 * 32, : w // 32 * 32]

    eng = StereoEngine(args.model_type, checkpoint=args.checkpoint,
                       precision=args.precision, refine_iter=args.num_refine,
                       use_positivity=not args.allow_negative, device=args.device)
    disp, occ, conf, score, ms = eng.run(left, right, n_repeat=args.n_repeat)
    print(f"confidence score: {score:.4f}")
    print(f"runtime: {ms:.1f} ms ({1e3 / ms:.1f} FPS)")
    print(f"disparity range: [{disp.min():.2f}, {disp.max():.2f}]")

    if args.show:
        show_results_2d(left, disp, occ, conf)
    else:
        write_png(args.out, render_results_2d(left, disp, occ, conf)[..., ::-1])
        print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
