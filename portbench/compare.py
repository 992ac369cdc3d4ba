"""The numbers by which a served request is held against the reference.

Each number is the worst over the pairs of one request. A cell's limits
file names the numbers it compares and their limits; `PERF.md` gives the
readings each limit was set from.

The disparity is compared where the reference's own matcher found a clear
winner (`CLEAR`). Elsewhere the model inpaints it from a hundred times a
convolution's output and clamps it at 0, so on random weights the whole
inpainted map moves with the last bits of that output, or sits at 0 for
any precision on some seeds.
"""
from __future__ import annotations

import numpy as np

# a pixel's disparity is clear where the matcher put more than this share of
# its transport mass within two columns of its best match, in all of the
# pixel's 3x3 neighbourhood at 1/4 resolution (the model keeps the matcher's
# disparity above 0.2 and inpaints below it)
CLEAR = 0.3


def pair_numbers(disp, occ, conf, rdisp, rocc, rconf, match) -> dict:
    """The gaps of one pair's maps from the reference's; `match` is the
    reference's `clear_match` map. With no clear pixel the disparity's
    number is NaN, which fails any limit."""
    d = np.abs(disp.astype(np.float64) - rdisp)
    clear = match > CLEAR
    return {
        "disp_clear_median_px": float(np.median(d[clear])) if clear.any() else float("nan"),
        "occ_median": float(np.median(np.abs(occ.astype(np.float64) - rocc))),
        "conf_median": float(np.median(np.abs(conf.astype(np.float64) - rconf))),
    }


def request_numbers(out, ref) -> dict:
    """out: (disp, occ, conf, score) with (B, H, W) maps; ref: the
    reference's (disp, occ, conf, score, match)."""
    per_pair = [pair_numbers(*(m[i] for m in out[:3]), *(m[i] for m in ref[:3]), ref[4][i])
                for i in range(len(out[0]))]
    return {k: max(p[k] for p in per_pair) for k in per_pair[0]}


def sane(out, shape) -> bool:
    """What every request is checked for in the window, at no cost to it:
    maps of the request's shape and a finite score in [0, 1] (the mean of
    the interior confidence, so a NaN there shows in it)."""
    disp, occ, conf, score = out
    return (all(m.shape == shape for m in (disp, occ, conf))
            and np.isfinite(score) and 0.0 <= score <= 1.0)
