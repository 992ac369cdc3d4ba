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


def test_int8_wrappers_take_the_plain_version_on_cpu_and_check_inputs():
    from s2m2_torch.ops import int8_gemm as ig
    rng = np.random.default_rng(0)
    _build.reset_launch_counts()
    x = torch.from_numpy(rng.standard_normal((2, 5, 40)).astype(np.float32))
    a = ig.quantize_pack(x, 20.0)
    assert a.dtype == torch.int8 and a.shape == (10, 64) and not a[:, 40:].any()
    w = torch.from_numpy(rng.integers(-127, 128, (8, 64)).astype(np.int8))
    acc = ig.int8_gemm(a, w, out_dtype=torch.int32)
    np.testing.assert_array_equal(acc.numpy(), a.numpy().astype(np.int64)
                                  @ w.numpy().astype(np.int64).T)
    ig.bf16_gemm(x.reshape(10, 40).bfloat16(), x.reshape(10, 40).bfloat16())
    assert all(n == 0 for n in _build.launch_counts.values())
    with pytest.raises(ValueError):
        ig.int8_gemm(a, w[:, :32], out_dtype=torch.int32)  # K differs
    with pytest.raises(ValueError):
        ig.int8_gemm(a, w)  # dequantizing needs w_scale
    with pytest.raises(ValueError):
        ig.quantize_pack(x.to("meta"), 20.0)
    with pytest.raises(TypeError):
        ig.probe_chain(x.bfloat16(), torch.zeros(40, 40), "int8")  # int8 kind, float w


def _ulp_close(got, want):
    """Within one ulp of the output dtype (of the larger magnitude)."""
    mant = 7 if got.dtype == torch.bfloat16 else 23
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs()).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - mant)
    assert bool(((g - w).abs() <= ulp).all()), float((g - w).abs().max())


# (input shape, conv geometry or None, N, dtype): K not a multiple of 32,
# N = 8 and 16, M not a multiple of the 128-row tile, 3x3 stride 2 with
# padding, a (b, n, d) head view of a (B, heads, N, d) tensor, float32 out
INT8_CASES = [
    ((3, 100, 100), None, 8, torch.bfloat16),
    ((1000, 384), None, 16, torch.float32),
    ((2, 24, 17, 23), (3, 3, 2, 2, 1, 1), 40, torch.bfloat16),
    ((1, 64, 20, 30), (3, 3, 1, 1, 1, 1), 200, torch.bfloat16),
    ((2, 16, 9, 7), (3, 1, 1, 1, 1, 0), 48, torch.float32),
    ("head", None, 96, torch.bfloat16),
]


@pytest.mark.parametrize("shape,conv,n,dtype", INT8_CASES,
                         ids=["k100-n8", "fp32-n16", "3x3s2", "3x3-nchw-chunks",
                              "3x1-fp32", "head-view"])
def test_int8_kernels_match_plain_on_card(cuda, shape, conv, n, dtype):
    """quantize_pack against its plain version (bit-equal int8 rows); the
    int8 GEMM's int32 accumulators bit-equal to the exact plain product;
    its dequantized output within one ulp of the output dtype."""
    from s2m2_torch.ops import int8_gemm as ig
    g = torch.Generator(device=cuda).manual_seed(0)
    if shape == "head":  # head 1 of (B, heads, N, d) = (6, 2, 70, 64)
        x = torch.randn((6, 2, 70, 64), generator=g, device=cuda).to(dtype)[:, 1]
    else:
        x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    inv = ig.inv_scale(float(x.float().abs().max()) / 127.0)
    before = dict(_build.launch_counts)
    a = ig.quantize_pack(x, inv, conv=conv)
    assert torch.equal(a, ig.quantize_pack_plain(x, inv, conv))
    k = a.shape[1]
    w_q = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    w_q[:, (x.shape[1] * conv[0] * conv[1] if conv else x.shape[-1]):] = 0
    s_w = torch.rand((n,), generator=g, device=cuda) * 1e-3
    bias = torch.randn((n,), generator=g, device=cuda)
    s_x = 1.0 / inv
    acc = ig.int8_gemm(a, w_q, out_dtype=torch.int32)
    assert torch.equal(acc, ig.int8_gemm_plain(a, w_q, out_dtype=torch.int32))
    want = ig.int8_gemm_plain(a, w_q, s_w, s_x, bias, dtype)
    _ulp_close(ig.int8_gemm(a, w_q, s_w, s_x, bias, dtype), want)
    if conv is not None:  # straight into NCHW, in two chunks of output rows
        b, _, h, wd = x.shape
        ho, wo = ig.conv_out_hw(h, wd, conv)
        out = torch.empty((b, n, ho, wo), dtype=dtype, device=cuda)
        m = b * ho * wo
        for m0, m1 in ((0, m // 2), (m // 2, m)):
            part = ig.quantize_pack(x, inv, conv=conv, rows=(m0, m1))
            ig.int8_gemm(part, w_q, s_w, s_x, bias, dtype, out=out, m_base=m0)
        _ulp_close(out.permute(0, 2, 3, 1).reshape(m, n), want)
    torch.cuda.synchronize()
    assert _build.launch_counts["int8_quantize_pack"] > before["int8_quantize_pack"]
    assert _build.launch_counts["int8_gemm"] > before["int8_gemm"]


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_probe_chain_matches_plain_on_card(cuda, kind):
    """Kernel E at the probe's (8, 304, 384): int8 bit-equal to the plain
    chain; bf16 within 2e-2 * max|ref| (float32 sums in another order,
    eight bf16 roundings)."""
    from s2m2_torch.ops import int8_gemm as ig
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn((8, 304, 384), generator=g, device=cuda) * 0.1).bfloat16()
    if kind == "int8":
        w = torch.randint(-127, 128, (384, 384), generator=g, device=cuda,
                          dtype=torch.int8)
    else:
        w = (torch.randn((384, 384), generator=g, device=cuda) * 0.05).bfloat16()
    got = ig.probe_chain(x, w, kind)
    want = ig.probe_chain_plain(x, w, kind)
    if kind == "int8":
        assert torch.equal(got, want)
    else:
        assert float((got.float() - want.float()).abs().max()) <= \
            2e-2 * float(want.float().abs().max())
