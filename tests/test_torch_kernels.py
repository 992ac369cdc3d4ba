"""The s2m2_torch kernel wrappers: the CPU path and its checks here, and on
a CUDA card the hand-written kernels against their plain PyTorch versions.
This file imports no JAX and uses no fixture of tests/conftest.py (which
imports JAX), so it also runs on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""
import numpy as np
import pytest
import torch

from s2m2_torch.ops import _build
from s2m2_torch.ops import flash_attention as fa
from s2m2_torch.ops import fused_block as fb
from s2m2_torch.ops import sinkhorn

torch.set_num_threads(2)


def test_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.default_rng(0)
    _build.reset_launch_counts()
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
               for _ in range(3))
    fa.scanline_attention(q, k, v)
    fa.scanline_cross_attention(q, k, v, q, k, v)
    sinkhorn.fused_correlation_ot(q.view(1, 2, 8, 16), k.view(1, 2, 8, 16))
    assert all(n == 0 for n in _build.launch_counts.values())


def test_wrappers_reject_mismatched_inputs():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):
        fa.scanline_attention(q, q, torch.zeros(2, 8, 8))
    with pytest.raises(ValueError):
        fa.scanline_attention(q, q.double(), q)
    with pytest.raises(ValueError):
        sinkhorn.fused_correlation_ot(q.view(1, 2, 8, 16), q.view(2, 1, 8, 16))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU path "
                    "(chip_smoke.py runs these comparisons on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(6, 48, 32), (4, 70, 16), (2, 65, 48), (2, 90, 96),
                                   (2, 129, 128), (2, 70, 192), (3, 130, 384),
                                   (2, 33, 5)])
def test_attention_kernels_match_plain_on_card(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    xs = [torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(6)]
    before = dict(_build.launch_counts)
    got = [fa.scanline_attention(*xs[:3]), *fa.scanline_cross_attention(*xs)]
    want = [fa.scanline_attention_plain(*xs[:3]),
            *fa.scanline_cross_attention_plain(*xs)]
    for a, b in zip(got, want):
        tol = 1e-4 if dtype == torch.float32 else 2e-2 * float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= tol
    assert _build.launch_counts["scanline_attention"] == before["scanline_attention"] + 1
    assert (_build.launch_counts["scanline_cross_attention"]
            == before["scanline_cross_attention"] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_positivity", [True, False])
def test_ot_kernel_matches_plain_on_card(cuda, dtype, use_positivity):
    from s2m2_torch.models.layers import layer_norm
    g = torch.Generator(device=cuda).manual_seed(0)
    f0, f1 = (layer_norm(torch.randn((1, 6, 40, 24), generator=g, device=cuda)).to(dtype)
              for _ in range(2))
    prob, cv = sinkhorn.fused_correlation_ot(f0, f1, use_positivity=use_positivity)
    prob_w, cv_w = sinkhorn.fused_correlation_ot_plain(f0, f1,
                                                       use_positivity=use_positivity)
    if dtype == torch.float32:
        torch.testing.assert_close(prob, prob_w, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(cv, cv_w, rtol=0, atol=1e-3)
    else:
        for a, b in ((prob, prob_w), (cv, cv_w)):
            assert float((a.float() - b.float()).abs().max()) <= \
                2e-2 * float(b.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pairs,w,c,heads,e", [(3, 24, 16, 4, 1), (2, 33, 48, 4, 1),
                                               (2, 40, 48, 2, 1), (2, 70, 128, 1, 1),
                                               (2, 50, 384, 2, 1), (2, 65, 384, 1, 1),
                                               (3, 20, 8, 1, 2), (2, 9, 512, 4, 1)])
def test_fused_block_kernel_matches_plain_on_card(cuda, pairs, w, c, heads, e, dtype):
    """Kernel D at head dims 4 to 384 and odd W: float32 within
    1e-4 * max(1, max|ref|), bfloat16 within 2e-2 * max|ref|."""
    from s2m2_torch.models.attention import BasicAttnBlock
    from s2m2_torch.models.init import _basic_attn_block, _Rng
    from s2m2_torch.tools.convert import flatten, from_jax
    blk = BasicAttnBlock(c, heads, e)
    blk.load_state_dict(from_jax(flatten(_basic_attn_block(_Rng(0), c, heads, e))))
    wts = [t.detach().to(cuda, dtype) for t in blk.fused_weights()]
    g = torch.Generator(device=cuda).manual_seed(0)
    rows = torch.randn((2 * pairs, w, c), generator=g, device=cuda).to(dtype)
    before = _build.launch_counts["fused_basic_attn_block"]
    got = fb.fused_basic_attn_block(rows, pairs, wts, heads)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_basic_attn_block"] == before + 1
    ref = torch.cat(fb.fused_basic_attn_block_plain(rows[:pairs], rows[pairs:], wts,
                                                    heads)).float()
    top = float(ref.abs().max())
    tol = 1e-4 * max(1.0, top) if dtype == torch.float32 else 2e-2 * top
    assert float((got.float() - ref).abs().max()) <= tol
