"""Synthetic stereo scenes (numpy), copied from `s2m2_tpu/train/data.py`.

`_random_scene` gives a textured pair with exact ground-truth disparity;
the int8 engine calibrates its benchmark on one (a pinned seed), and the
tests draw held-out scenes from `synthetic_stereo_batches`. The rest of
that module (directory loaders) waits for the training slice.
"""
from __future__ import annotations

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
