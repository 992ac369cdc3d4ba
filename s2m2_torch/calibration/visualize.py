"""Before/after calibration visualization
(reference: src/s2m2/calibration/base.py:39-101).

Renders a panel: epipolar-line overlays of the raw and calibrated pairs plus
disparity/confidence maps before and after — returned as an image (headless)
with an optional interactive display. A copy of
s2m2_tpu/calibration/visualize.py on the port's engine (any object with
`run`); the drawing needs cv2.
"""
from __future__ import annotations

import numpy as np

from ..utils.vis import apply_colormap, draw_epipolar_lines, require_cv2


def render_calibration_comparison(engine, left, right, left_cal, right_cal,
                                  num_lines=20):
    """Run the engine on raw and calibrated pairs and compose a comparison.

    Returns (panel_bgr_uint8, before_score, after_score).
    """
    disp_b, occ_b, conf_b, score_b, _ = engine.run(left, right)
    disp_a, occ_a, conf_a, score_a, _ = engine.run(left_cal, right_cal)

    def u8(img):
        return np.clip(np.asarray(img), 0, 255).astype(np.uint8)

    rows = []
    rows.append(u8(draw_epipolar_lines(u8(left), u8(right), num_lines)))
    rows.append(u8(draw_epipolar_lines(u8(left_cal), u8(right_cal),
                                       num_lines)))
    disp_row = np.hstack([apply_colormap(disp_b), apply_colormap(disp_a)])
    conf_row = np.hstack([
        np.repeat((np.clip(conf_b, 0, 1) * 255).astype(np.uint8)[..., None],
                  3, -1),
        np.repeat((np.clip(conf_a, 0, 1) * 255).astype(np.uint8)[..., None],
                  3, -1)])
    width = max(r.shape[1] for r in rows + [disp_row, conf_row])

    def pad_to(img, w):
        if img.shape[1] == w:
            return img
        return np.pad(img, ((0, 0), (0, w - img.shape[1]), (0, 0)))

    panel = np.vstack([pad_to(r, width)
                       for r in rows + [disp_row, conf_row]])
    return panel, score_b, score_a


def show_calibration_comparison(engine, left, right, left_cal, right_cal):
    cv2 = require_cv2("show_calibration_comparison")
    panel, sb, sa = render_calibration_comparison(engine, left, right,
                                                  left_cal, right_cal)
    print(f"confidence before {sb:.4f} -> after {sa:.4f}")
    cv2.namedWindow("calibration before/after", cv2.WINDOW_NORMAL)
    cv2.imshow("calibration before/after", panel)
    cv2.waitKey(0)
    cv2.destroyAllWindows()
