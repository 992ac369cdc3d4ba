"""Gradients through the hand-written kernels.

The CUDA kernels fill outputs allocated with `torch.empty` through ctypes,
so a direct launch returns a tensor with no `grad_fn`: autograd would stop
there without an error. Kernels A, B and C therefore run, whenever grad is
enabled and an input requires it, inside a `torch.autograd.Function` of
their module: the forward launches the kernel as a direct call does, and
the backward recomputes the kernel's plain PyTorch version from the saved
inputs under `torch.enable_grad()` and returns its vector-Jacobian
product. That is the gradient of the very function the kernel computes;
the JAX package has no backward kernel either (its Pallas routes are off
when it trains, so it differentiates XLA's version of the same function).

Kernels D and E take no part in training: their wrappers call
`refuse_grad`, which raises rather than return a tensor that silently has
no gradient.
"""
from __future__ import annotations

import torch


def wants_grad(*tensors) -> bool:
    """True when autograd would record a call on `tensors`: grad mode is on
    and one of them requires grad. Serving (inference_mode, no_grad) is
    False here and keeps its direct launch."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors):
    """Raise for a kernel with no backward when autograd would record it."""
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{what}: this CUDA kernel has no backward and takes no part in "
            "training; run it under torch.no_grad() / torch.inference_mode(), or "
            "train with the route off (fused_block=False, a float precision)")


def plain_vjp(plain, inputs, needs, grads):
    """The vector-Jacobian product of `plain` at `inputs`: recompute it under
    enable_grad from detached copies of the inputs and pull `grads` (one per
    output; None for an output with no gradient) back to the inputs whose
    entry of `needs` is set. Returns one gradient or None per input."""
    leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
    with torch.enable_grad():
        outs = plain(*leaves)
    if isinstance(outs, torch.Tensor):
        outs = (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    wrt = [t for t in leaves if t.requires_grad]
    if not pairs or not wrt:
        return (None,) * len(inputs)
    got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                   allow_unused=True))
    return tuple(next(got) if t.requires_grad else None for t in leaves)
