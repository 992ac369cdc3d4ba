"""The reference of a request: what `StereoEngine.run` returns for a pair.

Frames whose sides are multiples of 32 need no padding and no crop, so a
request is the forward on the float32 frames, its maps at input
resolution, and the mean confidence over the interior 100 px in from each
edge (the reference's self-calibration score, model_utils.py:93-94),
averaged over every pair of the request. Beside them it gives where its
own matcher found a clear winner, for the comparison (`compare.py`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MARGIN = 100


def clear_match(matched, shape):
    """The matcher's confidence (B, 1, h, w) at 1/4 resolution, each pixel
    given the least of its 3x3 neighbourhood (the convex upsampling draws
    on that neighbourhood), repeated to the output's (H, W): (B, H, W)."""
    low = -F.max_pool2d(-matched, 3, stride=1, padding=1)
    s = shape[0] // low.shape[2]
    return low.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)[:, 0]


@torch.no_grad()
def run(model, left, right, device):
    """(disp, occ, conf, score, match) of uint8 (B, H, W, 3) frames: float32
    (B, H, W) maps, one pair at a time on `device`; `match` is
    `clear_match` of the matcher's confidence."""
    h, w = left.shape[1:3]
    if h % 32 or w % 32:
        raise ValueError(f"reference requests need sides that are multiples of 32, got {h}x{w}")
    maps = []
    for a, b in zip(left, right):
        ta, tb = (torch.from_numpy(np.asarray(x, np.float32))[None].to(device) for x in (a, b))
        *out, matched = model(ta, tb, match_conf=True)
        maps.append([o[0, ..., 0].cpu().numpy() for o in out]
                    + [clear_match(matched, out[0].shape[1:3])[0].cpu().numpy()])
    disp, occ, conf, match = (np.stack(m) for m in zip(*maps))
    inner = conf[:, MARGIN:-MARGIN, MARGIN:-MARGIN] if min(h, w) > 2 * MARGIN else conf
    return disp, occ, conf, float(inner.mean()), match
