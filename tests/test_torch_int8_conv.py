"""Kernel E's implicit-GEMM conv path (s2m2_torch/ops/int8_gemm.py), on the
CPU through its plain versions: the NHWC int8 tensor with the (dy, dx, c)
reordered weight gives the same int32 accumulators as the explicit im2col
rows with the OIHW-flattened weight; a conv site run through the port
equals the JAX package's `conv2d_maybe_quantized`; and the GEMM's instance
plan and the header the build compiles from it.

Tolerance of the site test: both packages quantize the same float32 input
with the same scale and sum int8 products exactly, then take float(acc) *
(s_w * s_x) in float32 with the scale product first, so the outputs agree
to 1e-6 of their scale (bit-equal in practice); the JAX side runs eagerly,
as in tests/test_torch_quant.py.
"""
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from s2m2_tpu.models import quant as jquant
from s2m2_torch.models import quant
from s2m2_torch.models.layers import Conv
from s2m2_torch.ops import _build
from s2m2_torch.ops import int8_gemm as ig

torch.set_num_threads(2)

# (input (B, C, H, W), conv geometry (kh, kw, sh, sw, ph, pw), N): 3x3
# stride 1 and 2 with padding, 3x1, 1x1, the 2x2 stride-2 ConvT mask head's
# 1x1 form (N = 4 x cout), C = 32 and 48 (Cp 64), and a 5x5 stride-2 one
CONV_CASES = {
    "3x3-c32": ((2, 32, 9, 11), (3, 3, 1, 1, 1, 1), 24),
    "3x3s2-c48": ((1, 48, 10, 13), (3, 3, 2, 2, 1, 1), 40),
    "3x1-c32": ((1, 32, 7, 9), (3, 1, 1, 1, 1, 0), 16),
    "1x1-c48": ((2, 48, 5, 6), (1, 1, 1, 1, 0, 0), 8),
    "convT2x2-c32": ((1, 32, 6, 7), (1, 1, 1, 1, 0, 0), 4 * 9),
    "5x5s2-c32": ((1, 32, 12, 10), (5, 5, 2, 2, 2, 2), 16),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_implicit_conv_equals_im2col_product(case):
    """int32 accumulators of the conv mode (NHWC pack, (dy, dx, c) weight)
    equal the explicit im2col product exactly; its dequantized NCHW output
    equals the explicit one bit for bit."""
    shape, conv, n = CONV_CASES[case]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    inv = ig.inv_scale(float(x.abs().max()) / 127.0)
    b, c, h, w = shape
    kh, kw = conv[:2]
    k = c * kh * kw
    w_q = torch.from_numpy(rng.integers(-127, 128, (n, ig.k_padded(k))).astype(np.int8))
    w_q[:, k:] = 0
    rows = ig.quantize_pack(x, inv, conv=conv)
    nhwc = ig.quantize_pack(x, inv, nhwc=True)
    assert nhwc.shape == (b, h, w, ig.k_padded(c)) and not nhwc[..., c:].any()
    taps = w_q if kh * kw == 1 else ig.conv_weight_taps(w_q, c, kh, kw)
    assert taps.shape == (n, kh * kw * ig.k_padded(c))
    want = ig.int8_gemm(rows, w_q, out_dtype=torch.int32)
    got = ig.int8_gemm(nhwc, taps, out_dtype=torch.int32, conv=conv)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), rows.numpy().astype(np.int64) @ w_q.numpy().astype(np.int64).T)
    s_w = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    ho, wo = ig.conv_out_hw(h, w, conv)
    out = torch.empty((b, n, ho, wo), dtype=torch.bfloat16)
    ig.int8_gemm(nhwc, taps, s_w, 1.0 / inv, bias, torch.bfloat16, out=out, conv=conv)
    ref = ig.int8_gemm(rows, w_q, s_w, 1.0 / inv, bias, torch.bfloat16)
    assert torch.equal(out.permute(0, 2, 3, 1).reshape(-1, n), ref)


def _conv_module(rng, cin, cout, k, stride):
    w = (rng.standard_normal((k, k, cin, cout)) * 0.05).astype(np.float32)  # HWIO
    bias = (rng.standard_normal(cout) * 0.01).astype(np.float32)
    mod = Conv(cin, cout, k, stride=stride)
    mod.weight.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    mod.bias.data = torch.from_numpy(bias)
    return w, bias, mod


@pytest.mark.parametrize("cin,k,stride", [(48, 3, 1), (32, 3, 2), (16, 3, 1)],
                         ids=["c48-implicit", "c32-s2-implicit", "c16-explicit"])
def test_conv_site_matches_jax_conv2d_maybe_quantized(cin, k, stride):
    """One conv site, float32, weights quantized inline in both packages,
    the same scale: the port's output against JAX's accumulator * scale +
    bias. C >= 32 takes the implicit path (an NHWC pack, no im2col rows),
    C = 16 the explicit im2col rows; the launch log says which."""
    rng = np.random.default_rng(1)
    cout = 24
    w, bias, mod = _conv_module(rng, cin, cout, k, stride)
    x = rng.standard_normal((2, 9, 11, cin)).astype(np.float32)  # NHWC
    s_x = float(np.abs(x).max()) / 127.0
    pad = k // 2
    with jquant.quantized([s_x]):
        acc = jquant.conv2d_maybe_quantized(
            jnp.asarray(x), {"weight": jnp.asarray(w)}, (stride, stride),
            [(pad, pad), (pad, pad)], ("NHWC", "HWIO", "NHWC"))
    want = np.asarray(acc) + bias
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    with torch.inference_mode(), quant.quantized([s_x]):
        got = mod(xt)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(np.abs(want).max()))
    packs = [r for r in quant.last_log() if r["kind"] == "pack"]
    assert [r["layout"] for r in packs] == ["nhwc" if ig.implicit(cin) else "im2col"]


def test_prequantized_conv_keeps_its_taps_and_shared_inputs_pack_once():
    """quantize_model stores the reordered weight once; two 3x3 convs that
    read one shared input (a conv block's two branches) take one NHWC
    pack."""
    rng = np.random.default_rng(2)
    mods = [_conv_module(rng, 32, 16, 3, 1)[2] for _ in range(2)]
    holder = torch.nn.ModuleList(mods)
    for m in mods:
        m.int8_prequantizable = True
    assert quant.quantize_model(holder) == 2
    for m in mods:
        want = ig.conv_weight_taps(m.w_q, 32, 3, 3)
        assert torch.equal(m.w_q_taps, want)
    x = torch.from_numpy(rng.standard_normal((1, 32, 8, 9)).astype(np.float32))
    with torch.inference_mode(), quant.quantized([0.03]):
        xs = quant.share_gemm_input(x)
        outs = [m(xs) for m in mods]
    assert all(o.shape == (1, 16, 8, 9) for o in outs)
    kinds = [(r["kind"], r.get("layout")) for r in quant.last_log() if r["kind"] != "gemm_site"]
    assert kinds == [("pack", "nhwc"), ("gemm", None), ("gemm", None)]
    quant.strip_model(holder)
    assert not hasattr(mods[0], "w_q_taps")


def test_plan_picks_a_legal_n_tile():
    """For every N from 8 to 1,536: the fewest tiles of at most 256
    columns, the tile a multiple of 16 (what 8-bit wgmma takes) from the
    table, the block within the card's shared memory, and its ring at
    least 4 stages deep."""
    legal = set(ig.N_TILES)
    for n in range(8, 1537, 8):
        for m in (64, 1216, 77824):
            p = ig.plan("int8", m, n)
            assert p.bn in legal and p.bn % 16 == 0 and p.bn <= 256
            assert -(-n // p.bn) == -(-n // 256)
            assert p.smem <= ig.MAX_SMEM and p.stages >= 4
            assert (p.bn, p.wgs) in ig._INSTANCES["int8"]
    assert ig.plan("int8", 77824, 8).bn == 32 and ig.plan("int8", 77824, 384).bn == 192
    assert ig.plan("int8", 64, 64).wgs == 1 and ig.plan("int8", 77824, 64).wgs == 2
    assert ig.plan("int8", 155648, 384).wgs == 3  # tall token rows: 192-row tiles
    assert ig.plan("int8", 155648, 384, conv=True).wgs == 2  # the gather keeps registers
    # taps by TMA box: stride 1 and Cp % 128 == 0 only; the rest gather
    assert ig.tap_tiles((3, 3, 1, 1, 1, 1), 384) and ig.tap_tiles((3, 1, 1, 1, 1, 0), 768)
    assert not ig.tap_tiles((3, 3, 2, 2, 1, 1), 384) and not ig.tap_tiles((3, 3, 1, 1, 1, 1), 64)
    with pytest.raises(ValueError):
        ig.plan("fp8", 64, 64)


def test_generated_header_matches_the_table():
    """The X-macro list the build writes equals `_INSTANCES`, and every
    (operand, N tile) it lists has its wgmma wrapper with N / 2
    accumulators."""
    text = ig.instances_header()
    listed = re.search(r"#define S2M2_GEMM_INSTANCES\(X\) (.*)", text).group(1)
    got = {tuple(int(v) for v in t.split(","))
           for t in re.findall(r"X\(([^)]*)\)", listed)}
    want = {(ig._OPS[op], bn, wgs, st) for op, table in ig._INSTANCES.items()
            for (bn, wgs), st in table.items()}
    assert got == want
    for op, bn, _, _ in want:
        ctype = "int8_t" if op == 0 else "__nv_bfloat16"
        shape = f"m64n{bn}k32.s32.s8.s8" if op == 0 else f"m64n{bn}k16.f32.bf16.bf16"
        body = text.split(f"struct Wgmma<{ctype}, {bn}>")[1].split("};")[0]
        assert shape in body and f"(&d)[{bn // 2}]" in body
        assert body.count("(d[") == bn // 2
    assert _build._generated_headers("int8_gemm") == {"int8_gemm_instances.h": text}


def test_cpu_conv_mode_takes_the_plain_version_and_checks_inputs():
    _build.reset_launch_counts()
    x = torch.zeros((1, 32, 4, 5))
    a = ig.quantize_pack(x, 1.0, nhwc=True)
    w = torch.zeros((8, 9 * 32), dtype=torch.int8)
    y = ig.int8_gemm(a, w, out_dtype=torch.int32, conv=(3, 3, 1, 1, 1, 1))
    assert y.shape == (20, 8) and all(v == 0 for v in _build.launch_counts.values())
    with pytest.raises(ValueError):  # weight depth is not kh * kw * Cp
        ig.int8_gemm(a, w[:, :256], out_dtype=torch.int32, conv=(3, 3, 1, 1, 1, 1))
    with pytest.raises(ValueError):  # conv mode needs the NHWC tensor
        ig.int8_gemm(a.reshape(20, 32), w, out_dtype=torch.int32, conv=(3, 3, 1, 1, 1, 1))
