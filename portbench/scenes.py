"""The benchmark's input pairs, made from the seed.

A frozen copy of s2m2_torch/train/data.py's `_random_scene`: a textured
canvas smoothed by a 3-tap box along each row (zero beyond its ends, as
np.convolve's "same"), a piecewise-constant disparity of random boxes, the
right view sampled from the canvas at x + d. The canvas and the sensor
noise added to the right view are drawn on the device from one
`torch.Generator`, the boxes from a numpy generator; the views are rounded
to uint8 and handed over as host arrays, the frames a camera delivers.
"""
from __future__ import annotations

import numpy as np
import torch


def disparity(rng, h, w, max_disp):
    """(h, w) int32 piecewise-constant disparity: a background level and
    3-7 boxes."""
    disp = np.full((h, w), rng.integers(2, max_disp // 2), np.int32)
    for _ in range(rng.integers(3, 8)):
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        hh, ww = rng.integers(h // 8, h // 2), rng.integers(w // 8, w // 2)
        disp[y0:y0 + hh, x0:x0 + ww] = rng.integers(2, max_disp)
    return disp


def scene(gen, rng, h, w, max_disp, noise, device):
    """(left, right, disp): uint8 (h, w, 3) views with right[x - d] =
    left[x] on each box, plus N(0, noise) on the right view."""
    canvas = torch.rand((h, w + max_disp + 8, 3), generator=gen, device=device) * 255
    padded = torch.nn.functional.pad(canvas, (0, 0, 1, 1))
    canvas = (padded[:, :-2] + padded[:, 1:-1] + padded[:, 2:]) / 3.0
    disp = disparity(rng, h, w, max_disp)
    src = torch.from_numpy(np.minimum(np.arange(w) + disp, canvas.shape[1] - 1)).to(device)
    right = torch.gather(canvas, 1, src.long()[..., None].expand(h, w, 3))
    right = right + torch.randn(right.shape, generator=gen, device=device) * noise
    left, right = (x.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
                   for x in (canvas[:, :w], right))
    return left, right, disp


def pool(seed: int, n: int, h: int, w: int, max_disp: int, noise: float, device):
    """n (left, right) uint8 (h, w, 3) pairs from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    return [scene(gen, rng, h, w, max_disp, noise, device)[:2] for _ in range(n)]
