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
                                   (2, 33, 5), (3, 40, 4), (2, 70, 24), (2, 90, 256),
                                   (2, 304, 384)])
def test_attention_kernels_match_plain_on_card(cuda, shape, dtype):
    """Every instance family: D = 4 and 5 (element loads), 24 (padded to
    32), 192 to 384 (float32's and bf16 384's query slices shared by 2-4
    warps), ragged N; float32 within 1e-4, bfloat16 within 2e-2 * max|ref|."""
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
@pytest.mark.parametrize("shape", [(8, 76, 64), (4, 152, 384), (6, 33, 5), (4, 304, 384),
                                   (16, 1216, 32)])
def test_packed_cross_attention_kernel_on_card(cuda, shape, dtype):
    """Kernel B on the packed (x | y) batch, the form the model calls, writes
    both directions into one tensor: equal to the two plain directions, one
    launch."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(3))
    b = shape[0] // 2
    before = _build.launch_counts["scanline_cross_attention"]
    got = fa.scanline_cross_attention_packed(q, k, v)
    torch.cuda.synchronize()
    assert _build.launch_counts["scanline_cross_attention"] == before + 1
    want = torch.cat(fa.scanline_cross_attention_plain(q[:b], k[:b], v[:b],
                                                       q[b:], k[b:], v[b:])).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_positivity", [True, False])
@pytest.mark.parametrize("shape", [(1, 6, 40, 24), (1, 256, 304, 128), (1, 256, 304, 384),
                                   (2, 3, 33, 24), (1, 5, 65, 40), (1, 4, 305, 64),
                                   (1, 3, 48, 20), (1, 3, 608, 32), (1, 2, 700, 24)])
def test_ot_kernel_matches_plain_on_card(cuda, shape, dtype, use_positivity):
    """Kernel C on both routes of `sinkhorn.plan`: S's and XL's 1216x1024
    shapes (clusters of 2 CTAs per row in bf16, 4 in float32, operands by
    TMA), ragged W (33, 65: one CTA; 305: slabs of unequal rows, operands
    by cp.async), ragged C (24, 40; 20, whose bf16 rows are not 16-byte
    multiples and are staged element by element), W = 608 (a cluster of 8,
    several correlation passes) and W = 700 (the streamed route); one
    launch per call. float32 prob within 1e-6 + 1e-4 |ref| and cv within
    1e-3; bfloat16 within 2e-2 * max|ref|."""
    from s2m2_torch.models.layers import layer_norm
    g = torch.Generator(device=cuda).manual_seed(0)
    f0, f1 = (layer_norm(torch.randn(shape, generator=g, device=cuda)).to(dtype)
              for _ in range(2))
    before = _build.launch_counts["fused_correlation_ot"]
    prob, cv = sinkhorn.fused_correlation_ot(f0, f1, use_positivity=use_positivity)
    torch.cuda.synchronize()
    assert _build.launch_counts["fused_correlation_ot"] == before + 1
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
                                               (3, 20, 8, 1, 2), (2, 9, 512, 4, 1),
                                               (2, 304, 384, 1, 1), (2, 152, 384, 2, 1),
                                               (2, 17, 20, 5, 1), (2, 24, 12, 3, 2)])
def test_fused_block_kernel_matches_plain_on_card(cuda, pairs, w, c, heads, e, dtype):
    """Kernel D at head dims 4 to 384, odd W, XL's two shapes (1/4 and 1/8
    scale) at 2 pairs, and bf16 rows of 40 and 24 bytes (weight tiles
    gathered without TMA, rows read element by element): float32 within
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
# padding, a (b, n, d) head view of a (B, heads, N, d) tensor, float32 out;
# convs with C >= 32 also run the conv mode (implicit GEMM): C = 32, 48
# (Cp 64) and 384, N = 8 and 200, 3x3 stride 1 and 2, 3x1, 1x1 (stride-1
# convs with Cp % 128 == 0 load taps by TMA, the others gather them); the
# last two are tall enough for the three-warpgroup instance (192-row tiles)
INT8_CASES = [
    ((3, 100, 100), None, 8, torch.bfloat16),
    ((1000, 384), None, 16, torch.float32),
    ((2, 24, 17, 23), (3, 3, 2, 2, 1, 1), 40, torch.bfloat16),
    ((1, 64, 20, 30), (3, 3, 1, 1, 1, 1), 200, torch.bfloat16),
    ((2, 16, 9, 7), (3, 1, 1, 1, 1, 0), 48, torch.float32),
    ("head", None, 96, torch.bfloat16),
    ((2, 32, 19, 23), (3, 3, 1, 1, 1, 1), 8, torch.bfloat16),
    ((1, 48, 17, 30), (3, 3, 2, 2, 1, 1), 200, torch.bfloat16),
    ((1, 384, 24, 38), (3, 3, 1, 1, 1, 1), 200, torch.bfloat16),
    ((1, 384, 13, 21), (3, 3, 1, 1, 1, 1), 8, torch.float32),
    ((2, 48, 9, 13), (1, 1, 1, 1, 0, 0), 40, torch.bfloat16),
    ((1, 64, 11, 9), (3, 1, 1, 1, 1, 0), 96, torch.bfloat16),
    ((2, 128, 80, 330), (3, 3, 1, 1, 1, 1), 150, torch.bfloat16),
    ((52800, 96), None, 150, torch.float32),
]


@pytest.mark.parametrize("shape,conv,n,dtype", INT8_CASES,
                         ids=["k100-n8", "fp32-n16", "3x3s2", "3x3-nchw-chunks",
                              "3x1-fp32", "head-view", "conv-c32-n8", "conv-c48-s2-n200",
                              "conv-c384-n200", "conv-c384-n8-fp32", "conv-1x1-c48",
                              "conv-3x1-c64", "conv-tall-n150", "rows-3wg-n150"])
def test_int8_kernels_match_plain_on_card(cuda, shape, conv, n, dtype):
    """quantize_pack against its plain version (bit-equal int8 rows); the
    int8 GEMM's int32 accumulators bit-equal to the exact plain product;
    its dequantized output within one ulp of the output dtype. A conv with
    C >= 32 also runs the conv mode: the NHWC pack bit-equal to its plain
    version, the implicit GEMM's int32 accumulators bit-equal to the
    explicit product, its NCHW output within one ulp."""
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
        if ig.implicit(x.shape[1]):
            nhwc = ig.quantize_pack(x, inv, nhwc=True)
            assert torch.equal(nhwc, ig.quantize_pack_plain(x, inv, nhwc=True))
            kh, kw = conv[:2]
            taps = w_q if kh * kw == 1 else ig.conv_weight_taps(w_q, x.shape[1], kh, kw)
            assert torch.equal(ig.int8_gemm(nhwc, taps, out_dtype=torch.int32, conv=conv),
                               acc)
            out = torch.empty((b, n, ho, wo), dtype=dtype, device=cuda)
            ig.int8_gemm(nhwc, taps, s_w, s_x, bias, dtype, out=out, conv=conv)
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
