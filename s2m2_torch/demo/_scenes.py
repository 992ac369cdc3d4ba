"""Synthesized default inputs of the demos, which stand in for the
reference's sample data (not in this repository). A demo given no input
path writes its files here into a temporary directory, logs one line, and
reads them back through the same readers a user's files go through:

- "2d": im0.png / im1.png, the seed-7 scene of `train.data._random_scene`
  (as `StereoEngine._benchmark_calib_pair` builds its calibration pair) at
  `SIZE`, chip_smoke.py's 1216x1024;
- "middlebury": the same pair and a calib.txt (cam0 / cam1 / doffs /
  baseline / width / height / ndisp) for full-size images, which the demo
  reads at half size (`intrinsic_scale` 0.5);
- "booster": the pair at twice `SIZE` (each pixel a 2x2 block, so the
  demo's 0.5x gives the scene back exactly) and a calib.xml (OpenCV
  FileStorage) with proj_matL and baselineLR;
- "calibration": chip_smoke.py phase 8's raw pair (`stereo_pair`, seed 0,
  16 px) as uint8 PNGs and the sensor calibration XML of
  `synthetic_calibration()` in the schema `utils.calib.parse_xml_calibration`
  reads.

Nothing is downloaded and nothing of it is kept in the repository.
"""
from __future__ import annotations

import logging
import os

import numpy as np

SIZE = (1024, 1216)  # (H, W) of the synthesized pairs
# The calibrations' focal length is 2000 px at twice SIZE, 1000 px at the
# size the 3D demos run at, where the scene's disparities span 2-96 px: a
# 30 mm baseline puts the boxes and most of the background (10 px and up)
# inside the Booster demo's 3 m depth truncation, and the rest beyond it.
BASELINE_MM = 30.0


def stereo_pair(rng, h, w, disp):
    """A smooth random texture and its copy shifted left by `disp` pixels
    (left pixel x matches right pixel x - disp), plus noise, in [0, 255]."""
    base = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1, 3)).astype(np.float32)
    left = np.repeat(np.repeat(base, 8, 0), 8, 1)[:h, :w]
    left = left + rng.normal(0, 8, left.shape).astype(np.float32)
    right = np.roll(left, -disp, axis=1) + rng.normal(0, 2, left.shape).astype(np.float32)
    return np.clip(left, 0, 255), np.clip(right, 0, 255)


def synthetic_calibration(width=1216, height=1024):
    """A sensor calibration at width x height (by default 1216x1024): fx =
    fy ~ 1000 at 1216 px wide, principal points near the centre and apart,
    5 distortion coefficients a camera, a -120 mm baseline and a stereo
    rotation of a few mrad."""
    from ..utils.calib import euler_to_rotation_matrix
    s = width / 1216
    t = height / 1024
    return {
        "left": {"fx": 1000.0 * s, "fy": 1000.0 * s, "cx": 611.3 * s, "cy": 509.2 * t,
                 "distortion": np.array([-0.05, 0.012, 0.0004, -0.0003, 0.001])},
        "right": {"fx": 1001.5 * s, "fy": 1001.5 * s, "cx": 604.8 * s, "cy": 514.6 * t,
                  "distortion": np.array([-0.048, 0.011, -0.0002, 0.0005, 0.0])},
        "stereo_extrinsic": {"rotation": euler_to_rotation_matrix(0.002, -0.003, 0.0015),
                             "translation": np.array([-120.0, 0.3, -0.5])},
    }


def scene_pair(h, w):
    """The seed-7 synthetic scene at h x w as a uint8 RGB pair."""
    from ..train.data import _random_scene
    left, right, _ = _random_scene(np.random.default_rng(7), h, w, max_disp=96)
    return tuple(np.rint(img).astype(np.uint8) for img in (left, right))


def _write_pair(directory, left, right, names=("im0.png", "im1.png")):
    from ..utils.png import write_png
    paths = [os.path.join(directory, n) for n in names]
    for path, img in zip(paths, (left, right)):
        write_png(path, img)
    return paths


def _csv(values):
    return ", ".join(repr(float(v)) for v in np.ravel(values))


def write_sensor_xml(path, calib):
    """Write a calibration dict (left / right intrinsics, stereo_extrinsic)
    as the sensor XML `utils.calib.parse_xml_calibration` reads; the RGB
    camera is the left one."""
    lines = ["<?xml version=\"1.0\"?>", "<calibration>"]
    for name, cam in (("left", calib["left"]), ("right", calib["right"]),
                      ("rgb", calib["left"])):
        lines.append(f"<distorted_{name}_intrinsic>")
        lines += [f"<{k}>{float(cam[k])!r}</{k}>" for k in ("fx", "fy", "cx", "cy")]
        lines += [f"<dist>{_csv(cam['distortion'])}</dist>", f"</distorted_{name}_intrinsic>"]
    for name, ext in (("stereo_extrinsic", calib["stereo_extrinsic"]),
                      ("left2rgb", {"rotation": np.eye(3), "translation": np.zeros(3)})):
        lines += [f"<{name}>", f"<rotation>{_csv(ext['rotation'])}</rotation>",
                  f"<translation>{_csv(ext['translation'])}</translation>", f"</{name}>"]
    lines.append("</calibration>\n")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def write_defaults(kind, directory):
    """Write demo `kind`'s synthesized inputs into `directory` and log one
    line; returns {file name: path}."""
    h, w = SIZE
    if kind == "calibration":
        raw = [np.rint(img).astype(np.uint8)
               for img in stereo_pair(np.random.default_rng(0), h, w, 16)]
        paths = _write_pair(directory, *raw, names=("left_raw.png", "right_raw.png"))
        paths.append(os.path.join(directory, "calib.xml"))
        write_sensor_xml(paths[-1], synthetic_calibration(w, h))
    elif kind == "booster":
        big = [np.repeat(np.repeat(img, 2, 0), 2, 1) for img in scene_pair(h, w)]
        paths = _write_pair(directory, *big)
        from ..utils.filestorage import write_filestorage
        paths.append(os.path.join(directory, "calib.xml"))
        write_filestorage(paths[-1], {
            "proj_matL": np.array([[2000.0, 0, w], [0, 2000.0, h], [0, 0, 1]]),
            "baselineLR": BASELINE_MM})
    elif kind in ("2d", "middlebury"):
        paths = _write_pair(directory, *scene_pair(h, w))
        if kind == "middlebury":
            paths.append(os.path.join(directory, "calib.txt"))
            cam = f"[2000 0 {w}; 0 2000 {h}; 0 0 1]"
            with open(paths[-1], "w") as f:
                f.write(f"cam0={cam}\ncam1={cam}\ndoffs=0\nbaseline={BASELINE_MM}\n"
                        f"width={2 * w}\nheight={2 * h}\nndisp=192\n")
    else:
        raise ValueError(f"write_defaults: unknown demo {kind!r}")
    logging.getLogger("s2m2_torch.demo").warning(
        "no input given: wrote the synthesized %s inputs (%s) to %s", kind,
        ", ".join(os.path.basename(p) for p in paths), directory)
    return {os.path.basename(p): p for p in paths}
