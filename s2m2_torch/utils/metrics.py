"""Stereo evaluation metrics: EPE, bad-N, D1, occlusion/confidence AUC (a copy
of s2m2_tpu/utils/metrics.py; the reference ships no eval harness,
SURVEY.md §5.5)."""
from __future__ import annotations

import numpy as np


def epe(pred, gt, valid=None):
    """Mean absolute disparity error over valid pixels."""
    err = np.abs(np.asarray(pred, np.float64) - np.asarray(gt, np.float64))
    if valid is None:
        valid = np.isfinite(gt)
    valid = valid & np.isfinite(gt)
    return float(err[valid].mean()) if valid.any() else float("nan")


def bad_ratio(pred, gt, threshold=2.0, valid=None):
    """Fraction of valid pixels with |err| > threshold (bad-2.0 etc.)."""
    err = np.abs(np.asarray(pred, np.float64) - np.asarray(gt, np.float64))
    if valid is None:
        valid = np.isfinite(gt)
    valid = valid & np.isfinite(gt)
    if not valid.any():
        return float("nan")
    return float((err[valid] > threshold).mean())


def d1_all(pred, gt, valid=None):
    """KITTI D1: err > 3px AND err > 5% of gt."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    err = np.abs(pred - gt)
    if valid is None:
        valid = np.isfinite(gt)
    valid = valid & np.isfinite(gt)
    if not valid.any():
        return float("nan")
    bad = (err > 3.0) & (err > 0.05 * np.abs(gt))
    return float(bad[valid].mean())


def confidence_auc(pred, gt, conf, valid=None, n_steps=20):
    """Sparsification AUC of EPE when removing lowest-confidence pixels first.

    Lower is better; equals the area under the EPE-vs-density curve when
    pixels are dropped in increasing-confidence order. Measures how well the
    confidence head ranks errors.
    """
    pred = np.asarray(pred, np.float64).ravel()
    gt = np.asarray(gt, np.float64).ravel()
    conf = np.asarray(conf, np.float64).ravel()
    if valid is None:
        valid = np.isfinite(gt)
    else:
        valid = np.asarray(valid).ravel() & np.isfinite(gt)
    err = np.abs(pred - gt)[valid]
    c = conf[valid]
    if err.size == 0:
        return float("nan")
    order = np.argsort(c)  # ascending confidence: dropped first
    err_sorted = err[order[::-1]]  # keep highest confidence first
    csum = np.cumsum(err_sorted) / np.arange(1, err.size + 1)
    fracs = np.linspace(0.05, 1.0, n_steps)
    idx = np.clip((fracs * err.size).astype(int) - 1, 0, err.size - 1)
    return float(np.trapezoid(csum[idx], fracs))


def evaluate_pair(pred_disp, gt_disp, conf=None, valid=None,
                  thresholds=(0.5, 1.0, 2.0, 4.0)):
    """Full metric dict for one frame."""
    out = {"epe": epe(pred_disp, gt_disp, valid),
           "d1_all": d1_all(pred_disp, gt_disp, valid)}
    for t in thresholds:
        out[f"bad_{t}"] = bad_ratio(pred_disp, gt_disp, t, valid)
    if conf is not None:
        out["conf_auc"] = confidence_auc(pred_disp, gt_disp, conf, valid)
    return out
