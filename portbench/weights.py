"""Seeded weights for a cell's plain reference and the program, made on the
device.

The rule is the architecture's (`layout` of `archs/<name>.py`: each
parameter's bound, or None for a norm's weight and bias) with the
configuration's `weight_gain` on its bound: every bounded parameter
uniform in +-gain x bound, norms at weight 1 and bias 0. At gain 1 each
layer keeps a third of its input's variance and the maps come out flat,
the same for every input; the cells use gain sqrt(2) (PERF.md). The draws
come from one `torch.Generator` on the device, in one call, and are
rounded to the dtype the program serves, so the program and the float32
reference get the same values exactly.
"""
from __future__ import annotations

import torch


def make(arch, cfg: dict, seed: int, device, gain: float, dtype=torch.bfloat16) -> dict:
    """{name: tensor} of the model `cfg` of architecture `arch` (the module
    of `archs/<name>.py`) on `device` in `dtype`, from `seed`."""
    with torch.device("meta"):
        plan = arch.layout(arch.reference(cfg))
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
