"""Online self-calibration demo (reference: demo/online_calibration.py; the
JAX package's demo/online_calibration.py): CEM, coordinate-descent or
keypoint refinement of the stereo extrinsics on a raw (unrectified) sensor
pair.

    python -m s2m2_torch.demo.online_calibration [--left_path L.png
        --right_path R.png --calib_xml calib.xml] [--method cem|gd|kp]
        [--model_type S] [--precision bf16] [--device cuda]

Without the three paths it writes a synthesized raw 1216x1024 pair and its
sensor calibration (`demo/_scenes.py`) into a temporary directory and reads
them back. `cem` and `gd` run the model on the card unless `--device cpu` is
given, with no OpenCV; `kp` (SIFT, essential matrix, pose) needs OpenCV and
exits with an error where it is not installed.
"""
from __future__ import annotations

import argparse
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--left_path", default=None, help="default: synthesized")
    ap.add_argument("--right_path", default=None, help="default: synthesized")
    ap.add_argument("--calib_xml", default=None, help="default: synthesized")
    ap.add_argument("--method", default="cem", choices=["cem", "gd", "kp"])
    ap.add_argument("--model_type", default="S", choices=["S", "M", "L", "XL"])
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--precision", default="bf16",
                    choices=["bf16", "fp32", "int8", "int8a", "int8r"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    given = [p is not None for p in (args.left_path, args.right_path, args.calib_xml)]
    if any(given) and not all(given):
        ap.error("give --left_path, --right_path and --calib_xml, or none of them")
    if args.method == "kp":
        try:
            import cv2  # noqa: F401
        except ImportError:
            print("online_calibration: --method kp needs OpenCV (cv2: SIFT, "
                  "findEssentialMat, recoverPose), which is not installed; "
                  "--method cem and gd need no OpenCV", file=sys.stderr)
            return 2

    from ..utils.calib import load_calibration_data
    from ..utils.image import read_images
    from . import _scenes

    with tempfile.TemporaryDirectory() as tmp:
        if not any(given):
            files = _scenes.write_defaults("calibration", tmp)
            args.left_path, args.right_path, args.calib_xml = (
                files["left_raw.png"], files["right_raw.png"], files["calib.xml"])
        left, right = read_images(args.left_path, args.right_path)
        calib = load_calibration_data(args.calib_xml)
    if calib is None:
        return 1

    if args.method == "kp":
        from ..calibration.keypoint import keypoint_based_calibration
        result = keypoint_based_calibration(left, right, calib)
    else:
        from ..calibration.cem import cem_calibration
        from ..calibration.grad_descent import gradient_descent_calibration
        from ..runtime.engine import StereoEngine
        eng = StereoEngine(args.model_type, checkpoint=args.checkpoint,
                           precision=args.precision, device=args.device)
        fn = cem_calibration if args.method == "cem" else gradient_descent_calibration
        result = fn(eng, left, right, calib)

    if isinstance(result, dict):
        print("\nresult:")
        for k in ("roll_delta", "pitch_delta", "yaw_delta",
                  "initial_confidence", "final_confidence"):
            if k in result:
                print(f"  {k}: {result[k]:+.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
