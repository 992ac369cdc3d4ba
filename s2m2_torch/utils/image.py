"""Image I/O, padding, cropping and rectification remap (reference:
src/s2m2/core/utils/image_utils.py).

Host-side, run once per frame before the model. `image_pad` and the uint8
remap of `rectify_images` go through the native library (`s2m2_torch.native`,
built with g++ at first use); `image_pad_plain` and `remap_plain` are their
numpy versions, which the tests hold the library against.
"""
from __future__ import annotations

import math
import os

import numpy as np


def read_images(left_path, right_path):
    """Load a stereo pair as RGB uint8 arrays (H, W, 3). PNG files go through
    `utils.png.read_png` on every machine, so the card's machine (no OpenCV,
    no PIL) and the CPU decode the same pixels; other files through cv2 (as
    s2m2_tpu/utils/image.py:read_images), else PIL, where one is installed."""
    return _read_image(left_path), _read_image(right_path)


def _read_image(path):
    path = str(path)
    if path.lower().endswith(".png"):
        from .png import read_png
        return read_png(path)
    try:
        import cv2
    except ImportError:
        pass
    else:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"{path}: cv2 could not read the image")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        ext = os.path.splitext(path)[1] or "(none)"
        raise ImportError(f"{path}: reading a {ext} image needs cv2 or PIL, and neither "
                          "is installed; PNG files need neither") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def downscale_half(img):
    """cv2.resize(img, (0, 0), fx=0.5, fy=0.5) (INTER_LINEAR) of a uint8
    (H, W[, C]) image in numpy. At exactly 0.5 OpenCV takes its 2x2 area
    path: each output pixel is the mean of its 2x2 block, rounded half up.
    The output size is round-half-to-even of H / 2 and W / 2; where that
    reaches past an odd edge, the last blocks average the pixels inside,
    rounded half to even (OpenCV's scalar edge loop)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"downscale_half: needs uint8, got {img.dtype}")
    h, w = img.shape[:2]
    oh, ow = int(np.rint(h / 2)), int(np.rint(w / 2))
    if oh == 0 or ow == 0:
        raise ValueError(f"downscale_half: a {h}x{w} image has no half-size pixels")
    pad = [(0, max(0, 2 * oh - h)), (0, max(0, 2 * ow - w))] + [(0, 0)] * (img.ndim - 2)
    x = np.pad(img, pad)[:2 * oh, :2 * ow].astype(np.uint16)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    out = (s + 2) >> 2
    if 2 * oh > h or 2 * ow > w:
        inside = np.pad(np.ones((h, w), np.uint16), pad[:2])[:2 * oh, :2 * ow]
        n = inside[0::2, 0::2] + inside[0::2, 1::2] + inside[1::2, 0::2] + inside[1::2, 1::2]
        n = n.reshape(n.shape + (1,) * (img.ndim - 2))
        out = np.where(n == 4, out, np.rint(s / n))
    return out.astype(np.uint8)


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
    zeros, to avoid border artifacts (reference: image_utils.py:27-71). Runs
    the native library frame by frame (`image_pad_plain` is the numpy
    version)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[1:3]
    if h % factor == 0 and w % factor == 0:
        return img
    from .. import native
    return np.stack([native.image_pad(frame, factor) for frame in img])


def image_pad_plain(img, factor=32):
    """numpy version of `image_pad` (the JAX package's body, without its
    native fast path)."""
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


def remap_plain(img, map_x, map_y):
    """cv2.remap(img, map_x, map_y, INTER_LINEAR, borderMode=BORDER_CONSTANT)
    in numpy: out[y, x] = img at (map_y[y, x], map_x[y, x]) by bilinear
    interpolation on the float32 coordinates, each of the four taps outside
    the image counting as 0. Float images keep the unrounded value (as
    cv2.remap does on float32); uint8 rounds to nearest, as the native remap
    does. img: (h, w[, c]); maps: (h_out, w_out) float32."""
    img = np.asarray(img)
    gray = img.ndim == 2
    if gray:
        img = img[..., None]
    h, w = img.shape[:2]
    ftype = np.float64 if img.dtype == np.float64 else np.float32
    # coordinates beyond one pixel outside have every tap outside: clamping
    # them keeps the integer casts defined and the result 0
    mx = np.clip(np.nan_to_num(np.asarray(map_x, np.float32), nan=-2.0), -2, w + 1)
    my = np.clip(np.nan_to_num(np.asarray(map_y, np.float32), nan=-2.0), -2, h + 1)
    x0f, y0f = np.floor(mx), np.floor(my)
    ax = (mx - x0f).astype(ftype)[..., None]
    ay = (my - y0f).astype(ftype)[..., None]
    x0, y0 = x0f.astype(np.int64), y0f.astype(np.int64)
    src = img.astype(ftype, copy=False)
    acc = np.zeros((*mx.shape, img.shape[2]), ftype)
    for dy in (0, 1):
        yy = y0 + dy
        wy = ay if dy else 1 - ay
        for dx in (0, 1):
            xx = x0 + dx
            wx = ax if dx else 1 - ax
            valid = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
            taps = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
            acc += np.where(valid, wy * wx * taps, 0)
    if img.dtype == np.uint8:
        acc = np.clip(np.floor(acc + 0.5), 0, 255)
    out = acc.astype(img.dtype)
    return out[..., 0] if gray else out


def rectify_images(left_img, right_img, rectification_data):
    """Stereo rectification remap of a raw pair with the maps of
    `utils.calib.compute_stereo_rectification` (reference:
    image_utils.py:108-136, which calls cv2.remap): uint8 pairs go through
    the native library, other dtypes through `remap_plain`. No OpenCV."""
    out = []
    for img, side in ((left_img, "left"), (right_img, "right")):
        mx, my = rectification_data[f"{side}MapX"], rectification_data[f"{side}MapY"]
        img = np.asarray(img)
        if img.dtype == np.uint8:
            from .. import native
            out.append(native.remap_bilinear(img, mx, my))
        else:
            out.append(remap_plain(img, mx, my))
    return tuple(out)
