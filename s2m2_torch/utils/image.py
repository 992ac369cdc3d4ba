"""Image padding and cropping (reference: src/s2m2/core/utils/image_utils.py).

Host-side numpy, run once per frame before the model.
"""
from __future__ import annotations

import math

import numpy as np


def _adaptive_avg_pool(x, out_h, out_w):
    """numpy port of F.adaptive_avg_pool2d bin semantics; x: (B, H, W, C)."""
    b, h, w, c = x.shape
    out = np.empty((b, out_h, out_w, c), np.float32)
    ys = (np.arange(out_h) * h) // out_h
    ye = -((np.arange(out_h) + 1) * -h // out_h)  # ceil
    xs = (np.arange(out_w) * w) // out_w
    xe = -((np.arange(out_w) + 1) * -w // out_w)
    for i in range(out_h):
        for j in range(out_w):
            out[:, i, j] = x[:, ys[i]:ye[i], xs[j]:xe[j]].mean(axis=(1, 2))
    return out


def _bilinear_resize(x, out_h, out_w):
    """align_corners=False bilinear resize; x: (B, H, W, C) float32."""
    b, h, w, c = x.shape
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    # torch align_corners=False: weights from the unclamped floor, only the
    # gather indices are clamped (so off-edge samples replicate)
    y0f = np.floor(ys)
    x0f = np.floor(xs)
    y0 = np.clip(y0f.astype(int), 0, h - 1)
    y1 = np.clip(y0f.astype(int) + 1, 0, h - 1)
    x0 = np.clip(x0f.astype(int), 0, w - 1)
    x1 = np.clip(x0f.astype(int) + 1, 0, w - 1)
    wy = (ys - y0f).reshape(1, -1, 1, 1).astype(np.float32)
    wx = (xs - x0f).reshape(1, 1, -1, 1).astype(np.float32)
    top = x[:, y0][:, :, x0] * (1 - wx) + x[:, y0][:, :, x1] * wx
    bot = x[:, y1][:, :, x0] * (1 - wx) + x[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def image_pad(img, factor=32):
    """Pad (B, H, W, C) to a multiple of `factor`, filling the border with a
    blurred (downsample -> bilinear upsample) copy of the image instead of
    zeros, to avoid border artifacts (reference: image_utils.py:27-71)."""
    img = np.asarray(img, np.float32)
    b, h, w, c = img.shape
    h_new = math.ceil(h / factor) * factor
    w_new = math.ceil(w / factor) * factor
    pad_h, pad_w = h_new - h, w_new - w
    if pad_h == 0 and pad_w == 0:
        return img
    pad = np.pad(img, ((0, 0), (pad_h // 2, pad_h - pad_h // 2),
                       (pad_w // 2, pad_w - pad_w // 2), (0, 0)))
    down = _adaptive_avg_pool(pad, max(h // factor, 1), max(w // factor, 1))
    blurred = _bilinear_resize(down, h_new, w_new)
    hs, ws = pad_h // 2, pad_w // 2
    blurred[:, hs:hs + h, ws:ws + w] = img
    return blurred


def image_crop(img, shape):
    """Center-crop (..., H, W, C) back to `shape` = (H, W)
    (reference: image_utils.py:73-103)."""
    h, w = img.shape[-3:-1]
    h_new, w_new = shape
    hs = (h - h_new) // 2
    ws = (w - w_new) // 2
    return img[..., hs:hs + h_new, ws:ws + w_new, :]
