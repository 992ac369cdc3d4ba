"""Stereo-aware training augmentation, a copy of `s2m2_tpu/train/augment.py`
(numpy; the reference ships no training code).

Host-side numpy transforms composed over batch dicts, the standard recipe
for RAFT-family stereo training:

  * asymmetric photometric jitter — brightness / contrast / gamma drawn
    independently for the left and right view, so the matcher cannot rely
    on absolute intensities;
  * right-view "eraser" occlusion — random rectangles on the right image
    are replaced with the mean color, simulating occlusions whose pixels
    have no correspondence (ground truth stays valid: the network must
    inpaint from context, exactly the confidence/occlusion supervision
    regime S2M2's occ head expects);
  * vertical flip — flipping BOTH views and the disparity map about the
    horizontal axis preserves rectified epipolar geometry (rows map to
    rows); horizontal flips would negate disparity and swap views, which
    the positivity-constrained configs cannot represent, so they are
    deliberately not offered.

Wrap any batch iterator: `augment_batches(batches, seed=0)`.
"""
from __future__ import annotations

import numpy as np


def photometric_jitter(img, rng, brightness=0.25, contrast=0.25, gamma=0.3):
    """Per-image brightness/contrast/gamma on a [0,255] float image.

    The draws are cast to float32 scalars: under NumPy 2's NEP-50 rules a
    float64 python scalar would otherwise promote the whole image to
    float64 (2x host memory, dtype leak into consumers)."""
    out = img.astype(np.float32) / np.float32(255.0)
    out = np.clip(out * np.float32(1.0 + rng.uniform(-contrast, contrast))
                  + np.float32(rng.uniform(-brightness, brightness)),
                  np.float32(0.0), np.float32(1.0))
    out = out ** np.float32(np.exp(rng.uniform(-gamma, gamma)))
    return out * np.float32(255.0)


def eraser_occlusion(img, rng, max_boxes=2, max_frac=0.25):
    """Replace up to max_boxes random rectangles with the image mean color
    (RAFT's eraser transform, applied to the RIGHT view only)."""
    h, w = img.shape[:2]
    out = img.copy()
    mean = img.reshape(-1, img.shape[-1]).mean(axis=0)
    for _ in range(rng.integers(0, max_boxes + 1)):
        # clamp low < high so small images / small max_frac stay legal
        bh_hi = max(int(h * max_frac), 2)
        bw_hi = max(int(w * max_frac), 2)
        bh = rng.integers(min(max(h // 16, 1), bh_hi - 1), bh_hi)
        bw = rng.integers(min(max(w // 16, 1), bw_hi - 1), bw_hi)
        y0 = rng.integers(0, h - bh + 1)
        x0 = rng.integers(0, w - bw + 1)
        out[y0:y0 + bh, x0:x0 + bw] = mean
    return out


def augment_sample(img0, img1, gt, valid, rng, *, p_photo=0.8, p_eraser=0.5,
                   p_vflip=0.5):
    """Augment one (left, right, disp, valid) sample; shapes preserved."""
    if rng.uniform() < p_photo:
        img0 = photometric_jitter(img0, rng)
        img1 = photometric_jitter(img1, rng)  # independent draws: asymmetric
    if rng.uniform() < p_eraser:
        img1 = eraser_occlusion(img1, rng)
    if rng.uniform() < p_vflip:
        img0, img1 = img0[::-1].copy(), img1[::-1].copy()
        gt, valid = gt[::-1].copy(), valid[::-1].copy()
    return img0, img1, gt, valid


def augment_batches(batches, seed=0, **kwargs):
    """Wrap a batch-dict iterator with per-sample augmentation."""
    rng = np.random.default_rng(seed)
    for batch in batches:
        img0 = batch["img0"].copy()
        img1 = batch["img1"].copy()
        gt = batch["gt_disp"].copy()
        valid = batch["valid"].copy()
        for b in range(img0.shape[0]):
            img0[b], img1[b], gt[b], valid[b] = augment_sample(
                img0[b], img1[b], gt[b], valid[b], rng, **kwargs)
        out = dict(batch)
        out.update(img0=img0, img1=img1, gt_disp=gt, valid=valid)
        yield out
