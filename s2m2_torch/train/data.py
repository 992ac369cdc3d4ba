"""Training data (numpy), copied from `s2m2_tpu/train/data.py`.

- `synthetic_stereo_batches`: procedural random-shape stereo pairs with
  exact ground-truth disparity (`_random_scene`; the int8 engine also
  calibrates its benchmark on one, a pinned seed);
- `directory_batches`: Middlebury-style scene directories
  (im0.png / im1.png / disp0GT.pfm) with random crops to a fixed shape.

Batches are dicts {img0, img1, gt_disp, valid} of (B, H, W, *) float32,
what `train.step.make_train_step` consumes.
"""
from __future__ import annotations

import glob
import os

import numpy as np


def _random_scene(rng, h, w, max_disp):
    """Piecewise-constant depth scene: textured background + random boxes.
    Returns (left, right, disp) with right = left shifted per-pixel."""
    # textured canvas wider than the view so shifts stay in-bounds
    canvas = rng.uniform(0, 255, (h, w + max_disp + 8, 3)).astype(np.float32)
    # smooth it a bit so matching is not pure noise
    k = 3
    kernel = np.ones(k) / k
    canvas = np.apply_along_axis(
        lambda m: np.convolve(m, kernel, mode="same"), 1, canvas)

    disp = np.full((h, w), float(rng.integers(2, max_disp // 2)), np.float32)
    for _ in range(rng.integers(3, 8)):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        hh, ww = rng.integers(h // 8, h // 2), rng.integers(w // 8, w // 2)
        disp[y0:y0 + hh, x0:x0 + ww] = float(rng.integers(2, max_disp))

    # left[x] = canvas[x]; right[x] = canvas[x + d] so that the left pixel
    # x_l reappears in the right view at x_l - d (positive disparity), i.e.
    # right[x_l - d] = canvas[x_l] = left[x_l] on piecewise-constant regions
    xs = np.arange(w)[None, :].repeat(h, 0)
    left = canvas[:, :w]
    src = np.clip(xs + disp.astype(np.int32), 0, canvas.shape[1] - 1)
    right = np.take_along_axis(canvas, src[..., None].repeat(3, -1), axis=1)
    return left, right, disp


def synthetic_stereo_batches(batch=2, height=128, width=160, max_disp=24,
                             seed=0, n_batches=None):
    """Infinite (or n_batches) generator of synthetic training batches."""
    rng = np.random.default_rng(seed)
    i = 0
    while n_batches is None or i < n_batches:
        img0 = np.empty((batch, height, width, 3), np.float32)
        img1 = np.empty((batch, height, width, 3), np.float32)
        gt = np.empty((batch, height, width, 1), np.float32)
        for b in range(batch):
            l, r, d = _random_scene(rng, height, width, max_disp)
            img0[b], img1[b], gt[b, ..., 0] = l, r, d
        yield {"img0": img0, "img1": img1, "gt_disp": gt,
               "valid": np.ones_like(gt)}
        i += 1


def directory_batches(root, batch=1, crop=(384, 512), seed=0, loop=True):
    """Middlebury-style scene loader with random crops to a static shape."""
    from ..tools.eval_dataset import read_pfm
    from ..utils.image import read_images

    scenes = sorted(d for d in glob.glob(os.path.join(root, "*"))
                    if os.path.exists(os.path.join(d, "disp0GT.pfm")))
    if not scenes:
        raise FileNotFoundError(f"no scenes under {root}")
    rng = np.random.default_rng(seed)
    ch, cw = crop
    while True:
        img0 = np.empty((batch, ch, cw, 3), np.float32)
        img1 = np.empty((batch, ch, cw, 3), np.float32)
        gt = np.empty((batch, ch, cw, 1), np.float32)
        valid = np.empty((batch, ch, cw, 1), np.float32)
        for b in range(batch):
            scene = scenes[rng.integers(len(scenes))]
            L, R = read_images(os.path.join(scene, "im0.png"),
                               os.path.join(scene, "im1.png"))
            D = read_pfm(os.path.join(scene, "disp0GT.pfm"))
            y0 = rng.integers(max(L.shape[0] - ch, 0) + 1)
            x0 = rng.integers(max(L.shape[1] - cw, 0) + 1)
            img0[b] = L[y0:y0 + ch, x0:x0 + cw]
            img1[b] = R[y0:y0 + ch, x0:x0 + cw]
            d = D[y0:y0 + ch, x0:x0 + cw]
            gt[b, ..., 0] = np.where(np.isfinite(d), d, 0)
            valid[b, ..., 0] = np.isfinite(d) & (d > 0)
        yield {"img0": img0, "img1": img1, "gt_disp": gt, "valid": valid}
        if not loop:
            break
