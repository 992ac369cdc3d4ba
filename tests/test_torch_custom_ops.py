"""Kernels A-E as `torch.library` custom ops (s2m2_torch/ops/library.py), on
the CPU: `torch.library.opcheck` on each op at small shapes (ragged W and
C included), the ops' CPU kernels equal to the plain versions, and their
fake implementations (meta tensors through the wrappers) giving the shape,
dtype and strides the plain versions give. The ops' CUDA kernels are held
against the direct launches in tests/test_torch_kernels.py on a card."""
import numpy as np
import pytest
import torch
from torch.library import opcheck

from s2m2_torch.ops import _build
from s2m2_torch.ops import flash_attention as fa
from s2m2_torch.ops import fused_block as fb
from s2m2_torch.ops import int8_gemm as ig
from s2m2_torch.ops import library  # noqa: F401  (registers the ops)
from s2m2_torch.ops import sinkhorn

torch.set_num_threads(2)
OPS = torch.ops.s2m2_torch
DTYPES = [torch.float32, torch.bfloat16]


def _randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _block_weights(c, heads, dtype):
    from s2m2_torch.models.attention import BasicAttnBlock
    from s2m2_torch.models.init import _basic_attn_block, _Rng
    from s2m2_torch.tools.convert import flatten, from_jax
    blk = BasicAttnBlock(c, heads)
    blk.load_state_dict(from_jax(flatten(_basic_attn_block(_Rng(0), c, heads, 1))))
    return [t.detach().to(dtype).contiguous() for t in blk.fused_weights()]


def _int8_cases(rng, dtype):
    """(pack args, gemm args) pairs: token rows with K 40 (Kp 64) into an
    NCHW output, an explicit 3x3 stride-2 im2col of C = 6 (K 54) in a row
    range, an NHWC pack of C = 40 (Cp 64) for a 3x3 implicit conv and a 1x1
    one, and raw int32 accumulators."""
    s_w = torch.from_numpy(rng.uniform(1e-3, 2e-3, 24).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(24).astype(np.float32))

    def w(n, k):
        return torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))

    x_rows = _randn(rng, (2, 5, 40), dtype)
    x_conv = _randn(rng, (2, 6, 9, 7), dtype)
    x_nhwc = _randn(rng, (2, 40, 6, 5), dtype)
    a_rows = ig.quantize_pack(x_rows, 20.0)
    a_conv = ig.quantize_pack(x_conv, 20.0, conv=(3, 3, 2, 2, 1, 1))
    a_nhwc = ig.quantize_pack(x_nhwc, 20.0, nhwc=True)
    return [
        ((x_rows, 20.0, None, None, False),
         (a_rows, w(24, 64), s_w, 0.05, bias, dtype, None, [2, 1, 5])),
        ((x_conv, 20.0, [3, 3, 2, 2, 1, 1], [3, 20], False),
         (a_conv, w(24, 64), s_w, 0.05, None, torch.float32, None, [2, 5, 4])),
        ((x_nhwc, 20.0, None, None, True),
         (a_nhwc, w(24, 9 * 64), s_w, 0.05, bias, dtype, [3, 3, 1, 1, 1, 1], [2, 6, 5])),
        ((x_nhwc, 12.5, None, None, True),
         (a_nhwc, w(24, 64), s_w, 0.05, bias, dtype, [1, 1, 1, 1, 0, 0], None)),
        ((x_rows, 7.0, None, None, False),
         (a_rows, w(8, 64), None, 1.0, None, torch.int32, None, None)),
    ]


def _cases(dtype):
    """(op, args) at small shapes: odd sequence lengths and head dims, a
    ragged OT row (W 7, C 12), a block with W 11 and 2 heads."""
    rng = np.random.default_rng(0)
    qkv = [_randn(rng, (4, 9, 20), dtype) for _ in range(3)]
    f = [_randn(rng, (1, 3, 7, 12), dtype) for _ in range(2)]
    cases = [(OPS.scanline_attention.default, tuple(qkv)),
             (OPS.scanline_attention.default, tuple(_randn(rng, (3, 33, 5), dtype)
                                                   for _ in range(3))),
             (OPS.scanline_cross_attention_packed.default, tuple(qkv)),
             (OPS.fused_correlation_ot.default, (*f, 3, True)),
             (OPS.fused_correlation_ot.default, (*f, 2, False)),
             (OPS.fused_basic_attn_block.default,
              (_randn(rng, (6, 11, 16), dtype), 3, _block_weights(16, 2, dtype), 2))]
    for pack, gemm in _int8_cases(rng, dtype):
        cases += [(OPS.int8_quantize_pack.default, pack), (OPS.int8_gemm.default, gemm)]
    return cases


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_opcheck(dtype):
    """Schema, autograd registration (none: a clear error, not a silent
    stop), fake tensor and AOT dispatch tests of every op, every case."""
    for op, args in _cases(dtype):
        opcheck(op, args)


def _plain(op, args):
    """The plain version each op's CPU kernel must equal."""
    name = op.__name__.split(".")[0]
    if name == "scanline_attention":
        return fa.scanline_attention_plain(*args)
    if name == "scanline_cross_attention_packed":
        return fa.packed_cross_attention_plain(*args)
    if name == "fused_correlation_ot":
        return sinkhorn.fused_correlation_ot_plain(*args)
    if name == "fused_basic_attn_block":
        rows, right0, weights, heads = args
        return torch.cat(fb.fused_basic_attn_block_plain(rows[:right0], rows[right0:],
                                                         weights, heads))
    if name == "int8_quantize_pack":
        return ig.quantize_pack_plain(*args)
    a, w, w_scale, s_x, bias, out_dtype, conv, nchw = args
    if conv is not None and conv[:2] == [1, 1]:
        a, conv = a.reshape(-1, a.shape[3]), None
    y = ig.int8_gemm_plain(a, w, w_scale, s_x, bias, out_dtype, conv)
    if nchw is None:
        return y
    b, h, wd = nchw
    return y.reshape(b, h * wd, -1).permute(0, 2, 1).reshape(b, -1, h, wd)


def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, list) and x and isinstance(x[0], torch.Tensor):
        return [t.to("meta") for t in x]
    return x


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_cpu_kernels_equal_plain_and_fakes_match_their_outputs(dtype):
    """Each op on CPU tensors returns the plain version's result bit for
    bit, and counts no launch; on meta tensors (its fake implementation)
    the same shapes, dtypes and strides."""
    _build.reset_launch_counts()
    for op, args in _cases(dtype):
        got = op(*args)
        want = _plain(op, args)
        fake = op(*(_meta(a) for a in args))
        got, want, fake = ((t,) if isinstance(t, torch.Tensor) else t
                           for t in (got, want, fake))
        for g, w, f in zip(got, want, fake, strict=True):
            assert torch.equal(g, w), op
            assert f.device.type == "meta"
            assert (f.shape, f.dtype, f.stride()) == (g.shape, g.dtype, g.stride()), op
    assert all(n == 0 for n in _build.launch_counts.values())


def test_wrappers_route_meta_tensors_to_the_ops():
    """The wrappers send meta tensors to the custom ops (the shapes of an
    XL forward trace without memory); E's chunked NCHW path copies the rows
    the functional GEMM op returns into its output."""
    q = torch.empty((4, 304, 128), device="meta", dtype=torch.bfloat16)
    assert fa.scanline_attention(q, q, q).shape == q.shape
    assert fa.scanline_cross_attention_packed(q, q, q).shape == q.shape
    f = torch.empty((1, 256, 304, 384), device="meta", dtype=torch.bfloat16)
    prob, cv = sinkhorn.fused_correlation_ot(f, f)
    assert prob.shape == cv.shape == (1, 256, 304, 304)
    x = torch.empty((1, 3, 64, 96), device="meta", dtype=torch.bfloat16)
    a = ig.quantize_pack(x, 10.0, conv=(3, 3, 2, 2, 1, 1), rows=(0, 700))
    assert a.shape == (700, 32) and a.dtype == torch.int8
    out = torch.empty((1, 40, 32, 48), device="meta", dtype=torch.bfloat16)
    w = torch.empty((40, 32), device="meta", dtype=torch.int8)
    s_w = torch.empty((40,), device="meta")
    assert ig.int8_gemm(a, w, s_w, 0.1, None, torch.bfloat16, out=out, m_base=800) is out
    nhwc = ig.quantize_pack(torch.empty((1, 384, 24, 38), device="meta"), 10.0, nhwc=True)
    assert nhwc.shape == (1, 24, 38, 384)
    taps = torch.empty((200, 9 * 384), device="meta", dtype=torch.int8)
    y = ig.int8_gemm(nhwc, taps, torch.empty((200,), device="meta"), 0.1, None,
                     torch.bfloat16, conv=(3, 3, 2, 2, 1, 1), nchw=(1, 12, 19))
    assert y.shape == (1, 200, 12, 19)


def test_fakes_raise_what_the_wrappers_raise():
    m = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError):
        OPS.scanline_attention(m, m, torch.empty((2, 8, 8), device="meta"))
    with pytest.raises(ValueError):
        OPS.scanline_cross_attention_packed(m[:1], m[:1], m[:1])
    with pytest.raises(ValueError):
        OPS.fused_correlation_ot(m.view(1, 2, 8, 16), m.view(2, 1, 8, 16), 3, True)
    with pytest.raises(ValueError):  # K of a and w differ
        OPS.int8_gemm(torch.empty((10, 64), device="meta", dtype=torch.int8),
                      torch.empty((8, 32), device="meta", dtype=torch.int8), None, 1.0,
                      None, torch.int32, None, None)
    with pytest.raises(ValueError):  # 12 output rows do not fill 2 x 3 x 3
        OPS.int8_gemm(torch.empty((12, 32), device="meta", dtype=torch.int8),
                      torch.empty((8, 32), device="meta", dtype=torch.int8),
                      torch.empty((8,), device="meta"), 1.0, None, torch.bfloat16, None,
                      [2, 3, 3])
    with pytest.raises(TypeError):
        OPS.int8_quantize_pack(torch.empty((4, 40), device="meta", dtype=torch.float64),
                               1.0, None, None, False)
