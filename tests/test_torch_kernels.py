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
    # meta tensors go to the custom op's fake implementation: shapes only
    m = ig.quantize_pack(x.to("meta"), 20.0)
    assert m.device.type == "meta" and m.shape == (10, 64) and m.dtype == torch.int8
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


def _vjp(fn, inputs, cots):
    """(outputs, input gradients) of fn at fresh leaves of `inputs`."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return outs, torch.autograd.grad(outs, leaves, cots)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,shape", [("A", (4, 128, 64)), ("A", (3, 96, 384)),
                                        ("B", (8, 128, 64)), ("C", (2, 12, 128, 64)),
                                        ("C", (1, 4, 96, 24))])
def test_gradients_through_kernels_equal_the_plain_versions_on_card(cuda, kind, shape,
                                                                    dtype):
    """With grad enabled and inputs requiring grad, A, B and C launch their
    kernel once (an autograd Function) and their gradients are the plain
    version's: the backward recomputes it, so they agree to the bit on the
    same cotangents. The forward stays within the kernel tolerances."""
    from s2m2_torch.models.layers import layer_norm
    g = torch.Generator(device=cuda).manual_seed(1)
    if kind == "C":
        inputs = [layer_norm(torch.randn(shape, generator=g, device=cuda)).to(dtype)
                  for _ in range(2)]
        b, h, w, _ = shape
        cots = tuple(torch.randn((b, h, w, w), generator=g, device=cuda).to(dtype)
                     for _ in range(2))
        fn, plain, name = (sinkhorn.fused_correlation_ot, sinkhorn.fused_correlation_ot_plain,
                           "fused_correlation_ot")
    else:
        inputs = [torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(3)]
        cots = (torch.randn(shape, generator=g, device=cuda).to(dtype),)
        fn, plain, name = ((fa.scanline_attention, fa.scanline_attention_plain,
                            "scanline_attention") if kind == "A" else
                           (fa.scanline_cross_attention_packed,
                            fa.packed_cross_attention_plain, "scanline_cross_attention"))
    before = dict(_build.launch_counts)
    outs, grads = _vjp(fn, inputs, cots)
    torch.cuda.synchronize()
    assert outs[0].grad_fn is not None
    assert _build.launch_counts[name] == before[name] + 1
    assert sum(_build.launch_counts.values()) == sum(before.values()) + 1
    want_outs, want = _vjp(plain, inputs, cots)
    for a, w in zip(grads, want):
        assert a.dtype == dtype and torch.equal(a, w)
    for a, w in zip(outs, want_outs):
        tol = 1e-3 if dtype == torch.float32 else 2e-2 * float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= tol


def test_fused_block_and_int8_kernels_refuse_grad_on_card(cuda):
    """D and E have no backward: on the card a call that autograd would
    record raises; under no_grad the same calls launch."""
    from s2m2_torch.models.attention import BasicAttnBlock
    from s2m2_torch.ops import int8_gemm as ig
    blk = BasicAttnBlock(32, 2).to(cuda)
    rows = torch.randn(4, 16, 32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        fb.fused_basic_attn_block(rows, 2, blk.fused_weights(), 2)
    x = torch.randn(64, 32, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ig.quantize_pack(x, 10.0)
    a = ig.quantize_pack(x.detach(), 10.0)
    w = torch.randint(-127, 128, (48, 32), dtype=torch.int8, device=cuda)
    scale = torch.full((48,), 0.01, device=cuda)
    bias = torch.zeros(48, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ig.int8_gemm(a, w, scale, 0.1, bias)
    wb = torch.randn(48, 32, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ig.bf16_gemm(x.detach().bfloat16(), wb)
    with torch.no_grad():
        fb.fused_basic_attn_block(rows, 2, blk.fused_weights(), 2)
        ig.int8_gemm(a, w, scale, 0.1, bias)
        ig.bf16_gemm(x.bfloat16(), wb)
    torch.cuda.synchronize()


def test_serving_makes_no_function_call_on_card(cuda, monkeypatch):
    """Under inference_mode a forward launches A, B and C directly, with the
    counts the shapes give, and never enters their autograd Functions; with
    grad enabled the same forward goes through them once a launch and
    reaches the MRT's q, k and v weights."""
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.models.init import init_params
    from s2m2_torch.models.s2m2 import S2M2
    calls = []
    for cls in (fa.ScanlineAttention, fa.ScanlineCrossAttention, sinkhorn.FusedCorrelationOT):
        orig = cls.apply
        monkeypatch.setattr(cls, "apply",
                            lambda *a, _o=orig, _n=cls.__name__: calls.append(_n) or _o(*a))
    cfg = ModelConfig(feature_channels=32, num_transformer=1, refine_iter=2)
    model = S2M2(cfg)
    model.load_state_dict(init_params(cfg, seed=0))
    model = model.to(cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    a, b = (torch.rand((1, 64, 96, 3), generator=g, device=cuda) * 255 for _ in range(2))
    names = ("scanline_attention", "scanline_cross_attention", "fused_correlation_ot")
    _build.reset_launch_counts()
    with torch.inference_mode():
        model(a, b)
    served = {n: _build.launch_counts[n] for n in names}
    assert calls == [] and served["fused_correlation_ot"] == 1
    assert served["scanline_attention"] > 0 and served["scanline_cross_attention"] > 0
    _build.reset_launch_counts()
    disp, _, _ = model(a, b)
    assert {n: _build.launch_counts[n] for n in names} == served
    assert len(calls) == sum(served.values())
    disp.mean().backward()
    mrt = model.transformer.uformer_list[0]
    for name, p in mrt.named_parameters():
        if name.endswith(("q.weight", "k.weight", "v.weight")):
            assert p.grad is not None and float(p.grad.abs().sum()) > 0, name


def _custom_op_cases(dev, dtype):
    """(launch counter, custom-op call, direct wrapper call) for each op of
    ops/library.py at small shapes: F, A, B (packed), C, D, E's three packs
    and its GEMM on rows, into NCHW, as an implicit 3x3 and a 1x1 conv."""
    from s2m2_torch.ops import int8_attention as ia
    from s2m2_torch.ops import int8_gemm as ig
    from s2m2_torch.ops import library  # noqa: F401  (registers the ops)
    ops = torch.ops.s2m2_torch
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    q, k, v = randn(6, 48, 32), randn(6, 48, 32), randn(6, 48, 32)
    f0, f1 = randn(1, 6, 40, 24), randn(1, 6, 40, 24)
    c, heads, pairs = 48, 4, 2
    blk_w = [t.detach().to(dev, dtype) for t in _seeded_block(c, heads).fused_weights()]
    rows = randn(2 * pairs, 33, c)
    x_rows, x_conv, x_nhwc = randn(2, 5, 40), randn(2, 6, 9, 7), randn(2, 48, 9, 13)
    geom = (3, 3, 2, 2, 1, 1)
    a_rows = ig.quantize_pack(x_rows, 20.0)
    a_nhwc = ig.quantize_pack(x_nhwc, 20.0, nhwc=True)
    w_rows, w_taps, w_1x1 = int8(24, 64), int8(24, 9 * 64), int8(24, 64)
    s_w = torch.rand((24,), generator=g, device=dev) * 1e-3
    bias = torch.randn((24,), generator=g, device=dev)
    conv3 = [3, 3, 1, 1, 1, 1]
    fq, fk, fv = randn(4, 70, 24), randn(4, 100, 24), randn(4, 100, 24)
    return [
        ("int8_attention", lambda: ops.int8_attention(fq, fk, fv, 0.02, 0.03, 0.03),
         lambda: ia.int8_attention(fq, fk, fv, 0.02, 0.03, 0.03)),
        ("scanline_attention", lambda: ops.scanline_attention(q, k, v),
         lambda: fa.scanline_attention(q, k, v)),
        ("scanline_cross_attention", lambda: ops.scanline_cross_attention_packed(q, k, v),
         lambda: fa.scanline_cross_attention_packed(q, k, v)),
        ("fused_correlation_ot", lambda: ops.fused_correlation_ot(f0, f1, 3, True),
         lambda: sinkhorn.fused_correlation_ot(f0, f1, 3, True)),
        ("fused_basic_attn_block", lambda: ops.fused_basic_attn_block(rows, pairs, blk_w, heads),
         lambda: fb.fused_basic_attn_block(rows, pairs, blk_w, heads)),
        ("int8_quantize_pack", lambda: ops.int8_quantize_pack(x_rows, 20.0, None, None, False),
         lambda: ig.quantize_pack(x_rows, 20.0)),
        ("int8_quantize_pack", lambda: ops.int8_quantize_pack(x_conv, 20.0, list(geom), [3, 30],
                                                              False),
         lambda: ig.quantize_pack(x_conv, 20.0, conv=geom, rows=(3, 30))),
        ("int8_quantize_pack", lambda: ops.int8_quantize_pack(x_nhwc, 20.0, None, None, True),
         lambda: ig.quantize_pack(x_nhwc, 20.0, nhwc=True)),
        ("int8_gemm", lambda: ops.int8_gemm(a_rows, w_rows, s_w, 0.05, bias, dtype, None, None),
         lambda: ig.int8_gemm(a_rows, w_rows, s_w, 0.05, bias, dtype)),
        ("int8_gemm", lambda: ops.int8_gemm(a_rows, w_rows, None, 1.0, None, torch.int32, None,
                                            None),
         lambda: ig.int8_gemm(a_rows, w_rows, out_dtype=torch.int32)),
        ("int8_gemm", lambda: ops.int8_gemm(a_rows, w_rows, s_w, 0.05, bias, dtype, None,
                                            [2, 1, 5]),
         lambda: ig.int8_gemm(a_rows, w_rows, s_w, 0.05, bias, dtype, nchw=(2, 1, 5))),
        ("int8_gemm", lambda: ops.int8_gemm(a_nhwc, w_taps, s_w, 0.05, bias, dtype, conv3,
                                            [2, 9, 13]),
         lambda: ig.int8_gemm(a_nhwc, w_taps, s_w, 0.05, bias, dtype, conv=conv3,
                              nchw=(2, 9, 13))),
        ("int8_gemm", lambda: ops.int8_gemm(a_nhwc, w_1x1, s_w, 0.05, bias, dtype,
                                            [1, 1, 1, 1, 0, 0], [2, 9, 13]),
         lambda: ig.int8_gemm(a_nhwc, w_1x1, s_w, 0.05, bias, dtype, conv=(1, 1, 1, 1, 0, 0),
                              nchw=(2, 9, 13))),
    ]


def _seeded_block(c, heads):
    from s2m2_torch.models.attention import BasicAttnBlock
    from s2m2_torch.models.init import _basic_attn_block, _Rng
    from s2m2_torch.tools.convert import flatten, from_jax
    blk = BasicAttnBlock(c, heads)
    blk.load_state_dict(from_jax(flatten(_basic_attn_block(_Rng(0), c, heads, 1))))
    return blk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_equal_direct_launches_on_card(cuda, dtype):
    """Each custom op's CUDA kernel (what an exported program launches)
    gives the direct wrapper's result to the bit, with one launch a call."""
    with torch.inference_mode():
        for counter, op_call, direct_call in _custom_op_cases(cuda, dtype):
            before = _build.launch_counts[counter]
            got = op_call()
            torch.cuda.synchronize()
            assert _build.launch_counts[counter] == before + 1, counter
            want = direct_call()
            got, want = ((t,) if isinstance(t, torch.Tensor) else t for t in (got, want))
            for a, b in zip(got, want, strict=True):
                assert a.shape == b.shape and a.dtype == b.dtype and a.stride() == b.stride()
                assert torch.equal(a, b), counter


def test_int8_attention_takes_the_plain_version_on_cpu_and_checks_inputs():
    from s2m2_torch.ops import int8_attention as ia
    rng = np.random.default_rng(0)
    _build.reset_launch_counts()
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 20, 16)).astype(np.float32))
               for _ in range(3))
    out = ia.int8_attention(q, k, v, 0.03, 0.03, 0.03)
    assert out.shape == q.shape and out.dtype == q.dtype and torch.isfinite(out).all()
    assert all(n == 0 for n in _build.launch_counts.values())
    with pytest.raises(TypeError):
        ia.int8_attention(q, k.double(), v, 0.03, 0.03, 0.03)
    with pytest.raises(ValueError):
        ia.int8_attention(q, k[:, :, :8], v, 0.03, 0.03, 0.03)
    with pytest.raises(ValueError):
        ia.int8_attention(q, k, v[:2], 0.03, 0.03, 0.03)
    m = ia.int8_attention(q.to("meta"), k.to("meta"), v.to("meta"), 0.03, 0.03, 0.03)
    assert m.device.type == "meta" and m.shape == q.shape


def _f_inputs(dev, q_shape, nk, dtype):
    """Seeded q (q_shape), k and v (B, nk, d) of `dtype` on `dev` and their
    scales (each input's max |x| / 127)."""
    g = torch.Generator(device=dev).manual_seed(0)
    b, _, d = q_shape
    q = torch.randn(q_shape, generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, nk, d), generator=g, device=dev).to(dtype) * s for s in (1.5, 2.0))
    return (q, k, v, *(float(x.float().abs().max()) / 127 for x in (q, k, v)))


# kernel F's card cases: S's int8_attn shapes (N = 304, 152, 76 and the
# 1216-token map; 76 on the fused route), XL's widest ((2, 304, 384): three
# column chunks, three k tiles of Q and K; (8, 1216, 96)), a padded head
# (24), keys fewer and more than queries (the fused route at Nk <= 128), a
# head of 160 (its second chunk past DP) and of 512 (two stages, four
# chunks)
F_CARD_CASES = [((4, 304, 128), 304), ((8, 152, 64), 152), ((16, 76, 64), 76),
                ((16, 1216, 32), 1216), ((3, 70, 24), 70), ((2, 40, 16), 100),
                ((2, 100, 384), 65), ((2, 304, 384), 304), ((8, 1216, 96), 1216),
                ((3, 130, 160), 200), ((1, 90, 512), 300)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_shape,nk", F_CARD_CASES)
def test_int8_attention_kernel_matches_plain_on_card(cuda, q_shape, nk, dtype):
    """Kernel F against its plain version at `F_CARD_CASES`, each by its
    plan (`ops.int8_attention.plan`: route, chunk width, stages). Each row
    within two quanta of its probabilities (2 s_v pmax_row: the kernel's p
    = rint(127 e) may differ by one from rint(attn 127 / pmax) where that
    lies within float32 rounding of a half) plus the output's rounding,
    and few elements beyond the rounding (`agreement`)."""
    from s2m2_torch.ops import int8_attention as ia
    q, k, v, s_q, s_k, s_v = _f_inputs(cuda, q_shape, nk, dtype)
    before = _build.launch_counts["int8_attention"]
    got = ia.int8_attention(q, k, v, s_q, s_k, s_v)
    torch.cuda.synchronize()
    assert _build.launch_counts["int8_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    res = ia.agreement(got, q, k, v, s_q, s_k, s_v)
    assert res["ok"], res


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_shape,nk", [((8, 1216, 32), 1216), ((4, 304, 128), 304),
                                        ((16, 76, 64), 76)])
def test_int8_attention_is_bitwise_repeatable_on_card(cuda, q_shape, nk, dtype):
    """Two launches on the same inputs give the same bits, on both routes
    (TMA at N = 1216 and 304, fused at N = 76)."""
    from s2m2_torch.ops import int8_attention as ia
    q, k, v, *sc = _f_inputs(cuda, q_shape, nk, dtype)
    first = ia.int8_attention(q, k, v, *sc)
    second = ia.int8_attention(q, k, v, *sc)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_int8_attention_shape_with_no_plan_raises_on_card(cuda):
    """A CUDA call with no plan raises, and nothing is launched: no queries
    or keys, a head past MAX_HEAD_DIM."""
    from s2m2_torch.ops import int8_attention as ia
    before = _build.launch_counts["int8_attention"]
    for q_shape, k_shape in (((2, 0, 16), (2, 30, 16)), ((2, 30, 16), (2, 0, 16)),
                             ((1, 8, 520), (1, 8, 520))):
        q = torch.zeros(q_shape, device=cuda, dtype=torch.bfloat16)
        k = torch.zeros(k_shape, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            ia.int8_attention(q, k, k, 0.03, 0.03, 0.03)
    assert _build.launch_counts["int8_attention"] == before


def test_int8_attention_agreement_catches_a_wrong_scale():
    """The card test's rule, on the CPU: the plain output itself passes; the
    same output 5% off in scale, or one row's output off by a tenth, fails."""
    from s2m2_torch.ops import int8_attention as ia
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 304, 64)).astype(np.float32) * s)
               for s in (1.0, 1.5, 2.0))
    sc = [float(x.abs().max()) / 127 for x in (q, k, v)]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(dtype) for x in (q, k, v))
        want = ia.int8_attention_plain(q, k, v, *sc)
        assert ia.agreement(want, q, k, v, *sc)["ok"]
        assert not ia.agreement((want.float() * 1.05).to(dtype), q, k, v, *sc)["ok"]
        row = want.clone()
        row[1, 7] = (row[1, 7].float() * 1.1).to(dtype)
        assert not ia.agreement(row, q, k, v, *sc)["ok"]


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,conv,n", [((2, 70, 96), None, 80),
                                          ((1, 128, 24, 38), (3, 3, 1, 1, 1, 1), 128),
                                          ((1, 48, 17, 30), (3, 3, 2, 2, 1, 1), 64)])
def test_int8_gemm_acc_bf16_epilogue_matches_plain_on_card(cuda, shape, conv, n, out_dtype):
    """Kernel E's bf16-accumulator epilogue (int8_acc_bf16) against its plain
    version, in row mode and in conv mode (TMA taps, gathered taps): within
    one ulp of the output dtype."""
    from s2m2_torch.ops import int8_gemm as ig
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    inv = ig.inv_scale(float(x.float().abs().max()) / 127.0)
    if conv is None:
        a = ig.quantize_pack(x, inv)
        w_q = torch.randint(-127, 128, (n, a.shape[1]), generator=g, device=cuda,
                            dtype=torch.int8)
        nchw = None
    else:
        a = ig.quantize_pack(x, inv, nhwc=True)
        w_q = torch.randint(-127, 128, (n, conv[0] * conv[1] * a.shape[3]), generator=g,
                            device=cuda, dtype=torch.int8)
        b, _, h, wd = x.shape
        nchw = (b, *ig.conv_out_hw(h, wd, conv))
    s_w = torch.rand((n,), generator=g, device=cuda) * 1e-3
    bias = torch.randn((n,), generator=g, device=cuda)
    got = ig.int8_gemm(a, w_q, s_w, 1.0 / inv, bias, out_dtype, conv=conv, nchw=nchw,
                       acc_bf16=True)
    want = ig.int8_gemm_plain(a, w_q, s_w, 1.0 / inv, bias, out_dtype, conv=conv,
                              acc_bf16=True)
    if nchw is not None:
        want = ig._rows_to_nchw(want, nchw)
    _ulp_close(got, want)
    plain = ig.int8_gemm(a, w_q, s_w, 1.0 / inv, bias, out_dtype, conv=conv, nchw=nchw)
    assert not torch.equal(plain, got)  # the epilogue changes the rounding
