"""Seeded weights for the S2M2 reference and the program, made on the device.

The rule is the reference initialisation's (s2m2_torch/models/init.py, after
the JAX package's) with the configuration's `weight_gain` on its bound:
every conv, transposed conv and linear weight and its bias uniform in
+-gain/sqrt(fan_in), norms at weight 1 and bias 0. At gain 1 each layer
keeps a third of its input's variance and the maps come out flat, the same
for every input; the cells use gain sqrt(2) (PERF.md). The draws come from
one `torch.Generator` on the device, in one call, and are rounded to the
dtype the program serves, so the program and the float32 reference get the
same values exactly.
"""
from __future__ import annotations

import torch

from .reference import model as ref


def layout(module: torch.nn.Module):
    """[(parameter name, shape, bound)] in state-dict order; bound None for a
    norm's weight (1) and bias (0)."""
    bounds = {}
    for prefix, m in module.named_modules():
        if isinstance(m, (ref.Conv, ref.ConvT, ref.Linear)):
            b = m.fan_in() ** -0.5
            for name, _ in m.named_parameters(recurse=False):
                bounds[f"{prefix}.{name}"] = b
        elif isinstance(m, ref.Norm):
            bounds[f"{prefix}.weight"] = bounds[f"{prefix}.bias"] = None
    out = []
    for name, p in module.named_parameters():
        if name not in bounds:
            raise KeyError(f"no initialisation rule for parameter {name}")
        out.append((name, tuple(p.shape), bounds[name]))
    return out


def make(cfg: dict, seed: int, device, gain: float, dtype=torch.bfloat16) -> dict:
    """{name: tensor} of the model `cfg` on `device` in `dtype`, from `seed`,
    each conv and linear uniform in +-gain/sqrt(fan_in)."""
    with torch.device("meta"):
        plan = layout(ref.S2M2(cfg))
    total = sum(torch.Size(s).numel() for _, s, b in plan if b is not None)
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, b in plan:
        n = torch.Size(shape).numel()
        if b is None:
            fill = 1.0 if name.endswith(".weight") else 0.0
            out[name] = torch.full(shape, fill, dtype=dtype, device=device)
            continue
        out[name] = ((u[at:at + n] * 2 - 1) * (b * gain)).view(shape).to(dtype)
        at += n
    return out
