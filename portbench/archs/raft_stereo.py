"""RAFT-Stereo (arXiv:2109.07547) in the benchmark: all of the harness's work
that depends on the model, found by a configuration's `"architecture":
"raft_stereo"`.

The program's entry is `StereoEngine.run(left, right)` on a
`RaftStereoConfig`, which returns (disp, None, None, None, runtime_ms): no
occlusion, confidence or score. The plain reference is
`portbench/reference/raft_stereo.py`'s `RAFTStereo`. A request is compared
over the whole disparity map: RAFT-Stereo has no positivity clamp and no
inpainting, so every pixel is the update loop's own output. No kernel of
the program's own runs only here, so no roofline is counted
(`attention_bound_ms` is absent).

The program under test is imported only inside `build_engine` and the
faults, so the reference side of a run loads nothing of it.
"""
from __future__ import annotations

import time
from unittest import mock

import numpy as np
import torch

from portbench.reference import raft_stereo as ref

# ------------------------------------------------------------- the program

def build_engine(cell, device, precision=None):
    """The program's engine of the cell's configuration, on its normal path.
    It takes the arguments of "model" that the program reads; the others
    hold the published defaults, which the program runs and the reference
    checks."""
    import dataclasses
    from s2m2_torch.config import RaftStereoConfig
    from s2m2_torch.runtime.engine import StereoEngine
    cfg = RaftStereoConfig(**{f.name: cell.model[f.name]
                              for f in dataclasses.fields(RaftStereoConfig)})
    return StereoEngine(cfg, precision=precision or cell.config["precision"], device=device)


def unpack(out):
    """run's (disp, None, None, None, runtime_ms) as ({"disp": (B, H, W)},
    None, runtime_ms); run gives an (H, W) map for a single pair."""
    disp, _, _, _, ms = out
    if disp.ndim == 2:
        disp = disp[None]
    return {"disp": disp}, None, ms


def sane(maps, score, shape) -> bool:
    """What every request is checked for in the window, at no cost to it:
    a disparity of the request's shape, finite everywhere."""
    disp = maps["disp"]
    return disp.shape == shape and bool(np.isfinite(disp).all())


# ----------------------------------------------------------- the reference

def reference(cfg: dict) -> torch.nn.Module:
    """The plain float32 RAFT-Stereo of `cfg`, on the current default device."""
    return ref.RAFTStereo(cfg)


def layout(module: torch.nn.Module):
    """[(parameter name, shape, bound)] in named_parameters order: each
    conv's weight and bias uniform in +-1/sqrt(fan_in) (torch's default
    bound for a conv); bound None for a batch norm's weight (1) and bias
    (0). The instance norms have no parameters; the batch norms' running
    statistics are buffers, left at 0 and 1."""
    bounds = {}
    for prefix, m in module.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            b = m.weight[0].numel() ** -0.5
            for name, _ in m.named_parameters(recurse=False):
                bounds[f"{prefix}.{name}"] = b
        elif isinstance(m, torch.nn.BatchNorm2d):
            bounds[f"{prefix}.weight"] = bounds[f"{prefix}.bias"] = None
    out = []
    for name, p in module.named_parameters():
        if name not in bounds:
            raise KeyError(f"no initialisation rule for parameter {name}")
        out.append((name, tuple(p.shape), bounds[name]))
    return out


@torch.no_grad()
def reference_request(model, left, right, device):
    """The float32 (B, H, W) disparity of uint8 (B, H, W, 3) frames, one
    pair at a time on `device`."""
    h, w = left.shape[1:3]
    if h % 32 or w % 32:
        raise ValueError(f"reference requests need sides that are multiples of 32, got {h}x{w}")
    maps = []
    for a, b in zip(left, right):
        ta, tb = (torch.from_numpy(np.asarray(x, np.float32))[None].to(device) for x in (a, b))
        maps.append(model(ta, tb)[0, ..., 0].cpu().numpy())
    return np.stack(maps)


# ----------------------------------------------------------- the comparison

def numbers(maps, reference_out) -> dict:
    """|program - reference| of the disparity over every pixel: its median
    and its 99th percentile, each the worst over the request's pairs."""
    per_pair = []
    for disp, rdisp in zip(maps["disp"], reference_out):
        d = np.abs(disp.astype(np.float64) - rdisp)
        per_pair.append({"disp_median_px": float(np.median(d)),
                         "disp_p99_px": float(np.percentile(d, 99))})
    return {k: max(p[k] for p in per_pair) for k in per_pair[0]}


# ----------------------------------------------- faults and the control

def _disp_plus1():
    """The disparity one pixel off where the model produces it."""
    from s2m2_torch.models import raft_stereo
    forward = raft_stereo.RAFTStereo.forward

    def altered(self, img0, img1, iters=None):
        disp, occ, conf = forward(self, img0, img1, iters)
        return disp + 1.0, occ, conf

    return mock.patch.object(raft_stereo.RAFTStereo, "forward", altered)


def _one_iteration_fewer():
    """The update loop stopped one iteration short of the configuration's."""
    from s2m2_torch.models import raft_stereo
    forward = raft_stereo.RAFTStereo.forward

    def altered(self, img0, img1, iters=None):
        return forward(self, img0, img1, (self.cfg.iters if iters is None else iters) - 1)

    return mock.patch.object(raft_stereo.RAFTStereo, "forward", altered)


def _coarsest_level_dropped():
    """The lookup's taps of the pyramid's coarsest level read as zeros."""
    from s2m2_torch.models import raft_stereo
    lookup = raft_stereo.lookup_pyramid

    def altered(pyramid, x, dx):
        out = lookup(pyramid, x, dx)
        return out[:-1] + [torch.zeros_like(out[-1])]

    return mock.patch.object(raft_stereo, "lookup_pyramid", altered)


FAULTS = {"disp_plus1": _disp_plus1, "one_iteration_fewer": _one_iteration_fewer,
          "coarsest_level_dropped": _coarsest_level_dropped}


class ReferenceInPlace:
    """The reference behind `StereoEngine.run`'s interface, each conv and
    the correlation on TF32 operands: the precision below the float32 with
    TF32 off that the configuration states."""

    def __init__(self, model, device):
        self.model, self.device = model, device
        model.tf32 = True
        for m in model.modules():
            if isinstance(m, ref.Conv2d):
                m.tf32 = True

    def run(self, left, right):
        t = time.perf_counter()
        squeeze = left.ndim == 3
        if squeeze:
            left, right = left[None], right[None]
        disp = reference_request(self.model, left, right, self.device)
        return disp[0] if squeeze else disp, None, None, None, (time.perf_counter() - t) * 1e3


CONTROLS = {"ref_tf32": ReferenceInPlace}

# The gathers of the correlation lookup (`_interp1d`'s torch.gather), tried
# before yardstick.FAMILIES, which would file them under "copy / layout".
FAMILIES = (("correlation lookup", ("gather",)),)
