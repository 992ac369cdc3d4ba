"""1-D correlation pyramids and their lookup, for S2M2's local refiner
(reference: src/s2m2/core/model/submodules.py:19-60) and RAFT-Stereo's
update loop (RAFT-Stereo core/corr.py `CorrBlock1D`).

A pyramid is a list of levels, each a (B, H, W, W2_i) volume of one row's
correlations: level 0 the raw volume, level i + 1 level i average-pooled by
2 along the candidate axis (an odd last entry dropped, as avg_pool2d does).
Both references sample a level with F.grid_sample(align_corners=True) at an
exact integer row, so the sampling is 1D linear interpolation along the
candidate axis: a two-tap gather, each tap zeroed on its own outside [0,
W2_i - 1] (the grid_sample zero-padding semantics). Level i is sampled at
x / 2**i + dx for dx in -r..r, x the matched column at level 0.

S2M2 keeps two levels (the full volume and a width-halved copy) and looks
up x = column - disparity; RAFT-Stereo keeps `corr_levels` and looks up its
coordinates. Each pyramid built adds its bytes to the counter
`corr.volume_bytes`.
"""
from __future__ import annotations

import torch

from ..runtime import trace


def _interp1d(vol, pos):
    """Linear interpolation of vol (..., W2) at float32 positions pos
    (..., T), zero outside [0, W2-1] per tap. Returns vol's dtype."""
    w2 = vol.shape[-1]
    x0 = torch.floor(pos)
    a = pos - x0
    i0 = x0.long()
    i1 = i0 + 1
    volf = vol.float()

    def tap(i):
        inside = (i >= 0) & (i <= w2 - 1)
        return torch.gather(volf, -1, i.clamp(0, w2 - 1)) * inside

    return (tap(i0) * (1.0 - a) + tap(i1) * a).to(vol.dtype)


def make_pyramid(cv, levels):
    """cv: (B, H, W, W2) raw correlation. Returns the `levels` levels, cv
    first, and counts their bytes under `corr.volume_bytes`."""
    pyramid = [cv]
    for _ in range(levels - 1):
        v = pyramid[-1]
        n = v.shape[-1] // 2
        pyramid.append(v[..., :2 * n].reshape(*v.shape[:-1], n, 2).mean(dim=-1))
    trace.count("corr.volume_bytes", sum(v.numel() * v.element_size() for v in pyramid))
    return pyramid


def taps(radius, device):
    """The offsets -r..r of a lookup's 2r + 1 taps, float32."""
    return torch.linspace(-radius, radius, 2 * radius + 1, dtype=torch.float32, device=device)


def lookup_pyramid(pyramid, x, dx):
    """x: (B, H, W) float32 columns at level 0; dx: `taps(r)`. Returns one
    (B, 2r+1, H, W) map a level, each in its level's dtype."""
    x = x.unsqueeze(-1)
    return [_interp1d(vol, (x / 2 ** i if i else x) + dx).permute(0, 3, 1, 2)
            for i, vol in enumerate(pyramid)]


def make_cost_volume(cv, radius=4):
    """S2M2's two-level state: cv (B, H, W, W2) raw correlation. Returns
    (pyramid, taps)."""
    return make_pyramid(cv, 2), taps(radius, cv.device)


def cost_volume_lookup(state, disp):
    """disp: (B, 1, H, W) float32. Returns two (B, 2r+1, H, W) correlation
    feature maps (full-scale and half-scale lookups)."""
    pyramid, dx = state
    w = disp.shape[3]
    coords = torch.arange(w, dtype=torch.float32, device=disp.device)
    return lookup_pyramid(pyramid, coords - disp.float()[:, 0], dx)
