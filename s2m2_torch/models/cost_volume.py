"""Cost-volume lookup for iterative refinement
(reference: src/s2m2/core/model/submodules.py:19-60).

The reference samples a (B*H, 1, W, W) correlation image with
F.grid_sample(align_corners=True). The y coordinate is always an exact
integer row, so the sampling is 1D linear interpolation along the candidate
axis: a two-tap gather, each tap zeroed on its own outside [0, W2-1] (the
grid_sample zero-padding semantics). 9 taps (radius 4) at two scales: the
full volume and a width-halved average-pooled copy.
"""
from __future__ import annotations

import torch


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


def make_cost_volume(cv, radius=4):
    """cv: (B, H, W, W2) raw correlation. Returns the (cv, cv_2x, dx) state."""
    b, h, w, w2 = cv.shape
    cv_2x = cv.reshape(b, h, w, w2 // 2, 2).mean(dim=-1)
    dx = torch.linspace(-radius, radius, 2 * radius + 1, dtype=torch.float32,
                        device=cv.device)
    return cv, cv_2x, dx


def cost_volume_lookup(state, disp):
    """disp: (B, 1, H, W) float32. Returns two (B, 2r+1, H, W) correlation
    feature maps (full-scale and half-scale lookups)."""
    cv, cv_2x, dx = state
    w = disp.shape[3]
    coords = torch.arange(w, dtype=torch.float32, device=disp.device).view(1, 1, w, 1)
    d = disp.float().permute(0, 2, 3, 1)                      # (B,H,W,1)
    pos1 = coords - d + dx.view(1, 1, 1, -1)                  # (B,H,W,9)
    pos2 = coords / 2.0 - d / 2.0 + dx.view(1, 1, 1, -1)
    corrs = _interp1d(cv, pos1).permute(0, 3, 1, 2)
    corrs_2x = _interp1d(cv_2x, pos2).permute(0, 3, 1, 2)
    return corrs, corrs_2x
