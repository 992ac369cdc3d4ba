"""Gradients through kernels A, B and C (ops/_grad.py) on the CPU: each
autograd Function, with the kernel's plain version substituted for its
launch, gives the gradients of autograd through the plain version; the
guards of kernels D and E; and the deterministic backward of the bilinear
x2 upsample. The card runs the same Functions with the kernels in
tests/test_torch_kernels.py and chip_smoke.py."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from s2m2_torch.models import layers
from s2m2_torch.ops import _grad
from s2m2_torch.ops import flash_attention as fa
from s2m2_torch.ops import sinkhorn

torch.set_num_threads(2)


def _leaves(rng, shapes, dtype):
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
            .requires_grad_() for s in shapes]


def _grads(out, inputs, cots):
    outs = out if isinstance(out, tuple) else (out,)
    pairs = [(o, c) for o, c in zip(outs, cots) if c is not None]
    return torch.autograd.grad([o for o, _ in pairs], inputs, [c for _, c in pairs])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,plain,launch,batch", [
    (fa.ScanlineAttention, fa.scanline_attention_plain, "_attention_kernel", 3),
    (fa.ScanlineCrossAttention, fa.packed_cross_attention_plain, "_cross_kernel", 4),
], ids=["A", "B"])
def test_attention_functions_give_the_plain_gradients(monkeypatch, fn, plain, launch,
                                                      batch, dtype):
    monkeypatch.setattr(fa, launch, plain)
    rng = np.random.default_rng(0)
    q, k, v = _leaves(rng, [(batch, 20, 24)] * 3, dtype)
    cot = torch.from_numpy(rng.standard_normal((batch, 20, 24)).astype(np.float32)).to(dtype)
    got_out = fn.apply(q, k, v)
    got = _grads(got_out, (q, k, v), (cot,))
    want_out = plain(q, k, v)
    want = _grads(want_out, (q, k, v), (cot,))
    assert torch.equal(got_out, want_out)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("positivity", [True, False])
@pytest.mark.parametrize("which", ["both", "prob", "cv"])
def test_ot_function_gives_the_plain_gradients(monkeypatch, dtype, positivity, which):
    """Both outputs of C take a gradient; either alone too (the other's
    cotangent None)."""
    monkeypatch.setattr(sinkhorn, "_ot_kernel", sinkhorn.fused_correlation_ot_plain)
    rng = np.random.default_rng(1)
    f0, f1 = _leaves(rng, [(2, 3, 12, 8)] * 2, dtype)
    cots = [torch.from_numpy(rng.standard_normal((2, 3, 12, 12)).astype(np.float32)).to(dtype)
            for _ in range(2)]
    cots = [c if which in ("both", name) else None for c, name in zip(cots, ("prob", "cv"))]
    got_out = sinkhorn.FusedCorrelationOT.apply(f0, f1, 3, positivity)
    got = _grads(got_out, (f0, f1), cots)
    want_out = sinkhorn.fused_correlation_ot_plain(f0, f1, 3, positivity)
    want = _grads(want_out, (f0, f1), cots)
    for a, b in zip(got_out + got, want_out + want):
        assert torch.equal(a, b)


def test_function_with_one_input_requiring_grad(monkeypatch):
    monkeypatch.setattr(fa, "_attention_kernel", fa.scanline_attention_plain)
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(np.float32))
    k = q.clone().requires_grad_()
    out = fa.ScanlineAttention.apply(q, k, q)
    (gk,) = torch.autograd.grad(out.sum(), (k,))
    (want,) = torch.autograd.grad(fa.scanline_attention_plain(q, k, q).sum(), (k,))
    assert torch.equal(gk, want)


def test_wants_grad_and_refuse_grad():
    x = torch.zeros(3, requires_grad=True)
    y = torch.zeros(3)
    assert _grad.wants_grad(x, y) and not _grad.wants_grad(y)
    with torch.no_grad():
        assert not _grad.wants_grad(x)
        _grad.refuse_grad("k", x)
    with torch.inference_mode():
        assert not _grad.wants_grad(torch.zeros(3))
    _grad.refuse_grad("k", y)
    with pytest.raises(RuntimeError, match="no backward"):
        _grad.refuse_grad("k", y, x)


def test_cpu_paths_still_differentiate_through_the_plain_versions():
    """On CPU tensors every wrapper is its plain version, autograd included
    (D's plain block too): the guards act on the card only."""
    from s2m2_torch.ops import fused_block as fb
    rng = np.random.default_rng(3)
    q, k, v = _leaves(rng, [(4, 8, 16)] * 3, torch.float32)
    assert fa.scanline_attention(q, k, v).grad_fn is not None
    assert fa.scanline_cross_attention_packed(q, k, v).grad_fn is not None
    prob, cv = sinkhorn.fused_correlation_ot(q.view(1, 4, 8, 16), k.view(1, 4, 8, 16))
    assert prob.grad_fn is not None and cv.grad_fn is not None
    from s2m2_torch.models.attention import BasicAttnBlock
    blk = BasicAttnBlock(16, 2)
    rows = torch.from_numpy(rng.standard_normal((4, 8, 16)).astype(np.float32))
    out = fb.fused_basic_attn_block(rows, 2, blk.fused_weights(), 2)
    assert out.grad_fn is not None


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 2, 1, 4), (1, 1, 6, 1), (1, 4, 12, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_backward_is_the_interpolation_adjoint(shape, dtype):
    """The bilinear x2 upsample's matrix-product backward against autograd
    through F.interpolate: the forward is the same call; the gradients
    agree to float32 rounding (bf16: to its rounding of the result)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    y = layers.upsample2x_bilinear(x1)
    assert y.grad_fn is not None and "Upsample2xBilinear" in type(y.grad_fn).__name__
    y2 = F.interpolate(x2, scale_factor=2, mode="bilinear", align_corners=False)
    cot = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32)).to(dtype)
    (g1,), (g2,) = torch.autograd.grad(y, x1, cot), torch.autograd.grad(y2, x2, cot)
    assert torch.equal(y, y2) and g1.dtype == dtype
    tol = 2e-6 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(g1.float().numpy(), g2.float().numpy(), rtol=tol, atol=tol)
    with torch.no_grad():  # serving: the plain call, no Function
        assert torch.equal(layers.upsample2x_bilinear(x), y2.detach())
