"""Visualization helpers (reference: src/s2m2/core/utils/vis_utils.py), a copy
of s2m2_tpu/utils/vis.py. Every function here draws with OpenCV and imports
cv2 when it is called; nothing on the engine or calibration path calls them.

Headless-friendly: functions return images; interactive display (cv2 windows)
only happens in `show`-suffixed helpers.
"""
from __future__ import annotations

import numpy as np


def apply_colormap(disp, max_val=None):
    """JET-colormap disparity visualization (reference: vis_utils.py:38-41).
    Returns uint8 BGR."""
    import cv2
    disp = np.asarray(disp, np.float32)
    if max_val is None:
        max_val = max(float(np.nanmax(disp)), 1e-6)
    norm = np.clip(disp / max_val, 0, 1)
    return cv2.applyColorMap((norm * 255).astype(np.uint8), cv2.COLORMAP_JET)


def validity_mask(conf, occ, conf_thresh=0.1, occ_thresh=0.5):
    """The reference's display validity mask conf>0.1 & occ>0.5
    (reference: vis_utils.py:62)."""
    return (np.asarray(conf) > conf_thresh) & (np.asarray(occ) > occ_thresh)


def draw_epipolar_lines(left, right, num_lines=20):
    """Side-by-side pair with horizontal epipolar lines overlaid
    (reference: vis_utils.py:9-36). Returns uint8 image."""
    import cv2
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
    import cv2
    mask = validity_mask(conf, occ, conf_thresh, occ_thresh)
    disp_vis = apply_colormap(np.where(mask, disp, 0))
    conf_vis = (np.clip(conf, 0, 1) * 255).astype(np.uint8)
    conf_vis = cv2.cvtColor(conf_vis, cv2.COLOR_GRAY2BGR)
    left_bgr = cv2.cvtColor(np.asarray(left, np.uint8), cv2.COLOR_RGB2BGR)
    return np.hstack([left_bgr, disp_vis, conf_vis])


def show_results_2d(left, disp, occ, conf, window="s2m2 results"):
    import cv2
    panel = render_results_2d(left, disp, occ, conf)
    cv2.namedWindow(window, cv2.WINDOW_NORMAL)
    cv2.imshow(window, panel)
    print("Press any key to close...")
    cv2.waitKey(0)
    cv2.destroyAllWindows()
