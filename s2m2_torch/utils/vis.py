"""Visualization helpers (reference: src/s2m2/core/utils/vis_utils.py), from
s2m2_tpu/utils/vis.py. The disparity colormap and the 2D result panel are
numpy, so the demos draw them on the card's machine, which has no OpenCV;
the epipolar lines and the `show`-suffixed helpers, which open windows, call
OpenCV and raise a clear error where it is not installed.

Headless-friendly: functions return images; interactive display (cv2 windows)
only happens in `show`-suffixed helpers.
"""
from __future__ import annotations

import numpy as np


def require_cv2(what):
    """The cv2 module, or an ImportError naming `what` where it is missing."""
    try:
        import cv2
    except ImportError:
        raise ImportError(f"{what} draws with OpenCV (cv2), which is not installed") from None
    return cv2


def _jet_lut():
    """cv2.COLORMAP_JET as a (256, 3) uint8 BGR table: three clipped ramps of
    slope 4 a level; OpenCV's float table rounds blue at level 159 to 1."""
    v = np.arange(256)
    lut = np.stack([np.clip(np.minimum(4 * v + lo, hi - 4 * v), 0, 255)
                    for lo, hi in ((128, 638), (-128, 892), (-382, 1148))], axis=1)
    lut[159, 0] = 1
    return lut.astype(np.uint8)


JET = _jet_lut()


def apply_colormap(disp, max_val=None):
    """JET-colormap disparity visualization (reference: vis_utils.py:38-41),
    equal to cv2.applyColorMap(..., COLORMAP_JET). Returns uint8 BGR."""
    disp = np.asarray(disp, np.float32)
    if max_val is None:
        max_val = max(float(np.nanmax(disp)), 1e-6)
    norm = np.clip(disp / max_val, 0, 1)
    return JET[(norm * 255).astype(np.uint8)]


def validity_mask(conf, occ, conf_thresh=0.1, occ_thresh=0.5):
    """The reference's display validity mask conf>0.1 & occ>0.5
    (reference: vis_utils.py:62)."""
    return (np.asarray(conf) > conf_thresh) & (np.asarray(occ) > occ_thresh)


def draw_epipolar_lines(left, right, num_lines=20):
    """Side-by-side pair with horizontal epipolar lines overlaid
    (reference: vis_utils.py:9-36). Returns uint8 image."""
    cv2 = require_cv2("draw_epipolar_lines")
    combined = np.hstack([left, right]).copy()
    h = combined.shape[0]
    for i in range(1, num_lines + 1):
        y = int(h * i / (num_lines + 1))
        cv2.line(combined, (0, y), (combined.shape[1] - 1, y),
                 (0, 255, 0), 1)
    return combined


def render_results_2d(left, disp, occ, conf, conf_thresh=0.1, occ_thresh=0.5):
    """Compose the 2D result panel: left | colored disparity (masked) |
    confidence (reference: vis_utils.py:43-79). Returns uint8 BGR."""
    mask = validity_mask(conf, occ, conf_thresh, occ_thresh)
    disp_vis = apply_colormap(np.where(mask, disp, 0))
    conf_vis = np.repeat((np.clip(conf, 0, 1) * 255).astype(np.uint8)[..., None], 3, axis=2)
    left_bgr = np.asarray(left, np.uint8)[..., ::-1]
    return np.hstack([left_bgr, disp_vis, conf_vis])


def show_results_2d(left, disp, occ, conf, window="s2m2 results"):
    cv2 = require_cv2("show_results_2d")
    panel = render_results_2d(left, disp, occ, conf)
    cv2.namedWindow(window, cv2.WINDOW_NORMAL)
    cv2.imshow(window, panel)
    print("Press any key to close...")
    cv2.waitKey(0)
    cv2.destroyAllWindows()
