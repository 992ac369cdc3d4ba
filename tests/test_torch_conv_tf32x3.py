"""Kernel G (`s2m2_torch.ops.conv`): the split-TF32 float32 conv, its plan
(spatial and flat instances), the route `models/layers.py Conv` takes to
it, the weight split it reads, its custom op and counters. The kernel
itself runs only on a card (the last two tests here, skipped without one;
chip_smoke.py's `phase_conv` holds it at every routed shape of S, XL and
RAFT-Stereo). This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_conv_tf32x3.py -q
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.library import opcheck

from s2m2_torch.models import layers, quant
from s2m2_torch.ops import _build
from s2m2_torch.ops import conv
from s2m2_torch.ops import library  # noqa: F401  (registers the ops)
from s2m2_torch.runtime import trace

torch.set_num_threads(2)
OPS = torch.ops.s2m2_torch
# largest |error| over the largest |output|, against float64: float32's
# rounding at these depths is about 1e-6 of it, one TF32 pass about 1e-3
BOUND = 1e-5


def _operands(shape, seed=0):
    """Seeded x, weight (+-sqrt(2 / fan_in), as the benchmark's weights) and
    bias of a conv of `shape` = (b, c, h, w, n, kh, kw, ph, pw)."""
    b, c, h, w, n, kh, kw, _, _ = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32))
    lim = (2.0 / (c * kh * kw)) ** 0.5
    wt = torch.from_numpy(rng.uniform(-lim, lim, (n, c, kh, kw)).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.standard_normal(n).astype(np.float32))
    return x, wt, bias


def _rel_err(y, x, wt, bias, ph, pw):
    ref = F.conv2d(x.double(), wt.double(), bias.double(), padding=(ph, pw))
    return ((y.double() - ref).abs().max() / ref.abs().max()).item()


# 3x3, 3x1 and 1x3 as the model has them; odd channel counts (S's 130,
# XL's 386) and channels past one 32-channel chunk; row padding 0 (a band)
SHAPES = [(1, 130, 12, 20, 64, 3, 3, 1, 1), (1, 48, 10, 16, 40, 3, 1, 1, 0),
          (1, 40, 10, 16, 48, 1, 3, 0, 1), (1, 386, 6, 8, 32, 3, 3, 1, 1),
          (2, 64, 9, 12, 96, 3, 3, 0, 1)]
# 1x1 on the flat path: XL's deepest K (1536 channels) and RAFT-Stereo's
# 36; a flat tail inside one warpgroup's box (H W = 200), tails that leave
# the second warpgroup's box empty (H W = 132, 300), an N tail, batch 2
# and rows of 38 pixels (H W still a multiple of 4)
FLAT_SHAPES = [(1, 1536, 8, 12, 64, 1, 1, 0, 0), (1, 36, 10, 20, 64, 1, 1, 0, 0),
               (1, 64, 12, 11, 96, 1, 1, 0, 0), (1, 36, 10, 30, 64, 1, 1, 0, 0),
               (2, 48, 6, 38, 40, 1, 1, 0, 0)]


@pytest.mark.parametrize("shape", SHAPES + FLAT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_is_float32_accurate_and_one_tf32_pass_is_not(shape):
    """The plain version of G (split by cvt.rna rounding, three products,
    float32 sums) within float32-level error of a float64 conv; the same
    conv on TF32-rounded operands (one pass, as cuDNN's TF32) fails the
    same bound."""
    x, wt, bias = _operands(shape)
    kh, kw, ph, pw = shape[5:]
    y = conv.conv_tf32x3_plain(x, conv.split_weight(wt), bias, kh, kw, ph, pw)
    assert y.shape == conv.out_shape(x, conv.split_weight(wt), kh, kw, ph, pw)
    assert _rel_err(y, x, wt, bias, ph, pw) < BOUND
    one_pass = F.conv2d(conv.tf32_round(x), conv.tf32_round(wt), bias, padding=(ph, pw))
    assert _rel_err(one_pass, x, wt, bias, ph, pw) > 3 * BOUND


def test_tf32_split_rounds_to_nearest_ties_away():
    """big keeps 10 mantissa bits, rounded to nearest with ties away from
    zero (cvt.rna); small is the remainder rounded the same way, so big +
    small is x to about 22 bits."""
    one = 1.0
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4,
                      3.0, 0.0], dtype=torch.float32)
    big, small = conv.tf32_split(x)
    assert big.tolist() == [one + ulp, -(one + ulp), one, one + ulp, 3.0, 0.0]
    assert (big.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (small.view(torch.int32) & 0x1FFF).eq(0).all()
    r = torch.randn(10000)
    big, small = conv.tf32_split(r)
    assert ((big + small - r).abs() <= r.abs() * 2.0 ** -21).all()


def test_split_weight_layout():
    """(kh kw, 2, N, Cp): tap-major, big then small, channels innermost and
    zero-padded to a multiple of 4."""
    wt = torch.randn(6, 5, 3, 1)
    ws = conv.split_weight(wt)
    assert ws.shape == (3, 2, 6, 8) and ws.is_contiguous()
    big, small = conv.tf32_split(wt)
    assert torch.equal(ws[2, 0, :, :5], big[:, :, 2, 0])
    assert torch.equal(ws[1, 1, :, :5], small[:, :, 1, 0])
    assert ws[..., 5:].eq(0).all()


# plan: (shape, instance or None). The model's own shapes (S, XL and
# RAFT-Stereo at 1216x1024) and what the kernel does not take or gains
# nothing on; a 1x1 kernel gets a flat instance (`_FLAT_INSTANCES`)
PLANS = [
    ((1, 384, 256, 304, 384, 3, 3, 1, 1), (1, 128)),
    ((2, 384, 512, 608, 384, 3, 3, 1, 1), (1, 128)),
    ((1, 768, 256, 304, 384, 3, 1, 1, 0), (1, 128)),
    ((1, 768, 256, 304, 384, 1, 3, 0, 1), (1, 128)),
    ((1, 386, 256, 304, 384, 3, 3, 1, 1), (1, 128)),
    ((1, 384, 512, 608, 64, 3, 3, 1, 1), (2, 64)),
    ((1, 128, 64, 76, 128, 3, 3, 1, 1), (1, 64)),
    ((1, 48, 1024, 1216, 48, 3, 3, 1, 1), (2, 64)),
    ((1, 384, 256, 304, 384, 3, 3, 0, 1), (1, 128)),   # a band: row padding 0
    ((1, 384, 256, 304, 384, 1, 1, 0, 0), (1, 128)),   # 1x1
    ((1, 2, 256, 304, 64, 3, 3, 1, 1), None),          # 2 input channels
    ((1, 384, 256, 304, 2, 3, 3, 1, 1), None),         # 2 output channels
    ((1, 128, 64, 38, 128, 3, 3, 1, 1), None),         # rows of 152 bytes
    ((1, 128, 64, 76, 128, 5, 5, 2, 2), None),         # 5x5
    ((1, 128, 3, 8, 128, 3, 3, 0, 0), (1, 64)),        # one output row
    ((1, 128, 2, 8, 128, 3, 3, 0, 0), None),           # no output row
    ((2, 1536, 64, 76, 1536, 1, 1, 0, 0), (1, 128)),   # XL 1x1 at 1/16
    ((1, 768, 32, 38, 768, 1, 1, 0, 0), (1, 64)),      # XL 1x1 at 1/32: rows of 152 bytes
    ((2, 768, 256, 304, 768, 1, 1, 0, 0), (1, 128)),   # XL 1x1 at 1/4
    ((1, 128, 256, 304, 128, 1, 1, 0, 0), (1, 128)),   # S 1x1
    ((1, 256, 32, 38, 256, 1, 1, 0, 0), (1, 64)),      # S 1x1 at 1/32
    ((1, 36, 256, 304, 64, 1, 1, 0, 0), (2, 64)),      # RAFT-Stereo's 36 -> 64
    ((1, 256, 256, 304, 144, 1, 1, 0, 0), (2, 64)),    # RAFT-Stereo's 256 -> 144
    ((1, 384, 10, 3, 384, 1, 1, 0, 0), None),          # 1x1, H W = 30: planes of 120 bytes
    ((1, 9, 256, 304, 96, 1, 1, 0, 0), None),          # 1x1, 9 input channels
    ((2, 16, 1024, 1216, 16, 1, 1, 0, 0), None),       # 1x1, 16 output channels
    ((1, 384, 256, 304, 384, 1, 1, 0, 1), None),       # 1x1 with padding
]


@pytest.mark.parametrize("shape,inst", PLANS, ids=lambda v: str(v))
def test_plan(shape, inst):
    p = conv.plan(shape)
    if inst is None:
        assert p is None
        return
    b, c, h, w, n, kh, kw, ph, pw = shape
    flat = kh == kw == 1
    table = conv._FLAT_INSTANCES if flat else conv._INSTANCES
    assert (p.mt, p.bn) == inst and p.sb == table[inst] and p.flat == flat
    ho, wo = conv.out_hw(h, w, kh, kw, ph, pw)
    if flat:
        assert p.tiles == b * -(-h * w // (128 * p.mt)) * -(-n // p.bn)
    else:
        assert p.tiles == b * -(-ho // (8 * p.mt)) * -(-wo // 16) * -(-n // p.bn)
    assert p.rounds == -(-p.tiles // conv.SMS)


def test_instances_fit_and_the_header_lists_them():
    header = conv.instances_header()
    lists = {line.split("(X)")[0]: line for line in header.splitlines() if "(X)" in line}
    for macro, table, smem in (("#define S2M2_CONV_INSTANCES", conv._INSTANCES,
                                conv.smem_bytes),
                               ("#define S2M2_CONV1X1_INSTANCES", conv._FLAT_INSTANCES,
                                conv.flat_smem_bytes)):
        assert set(table) == set(conv._RATE if table is conv._INSTANCES else conv._FLAT_RATE)
        for (mt, bn), sb in table.items():
            assert smem(mt, bn, sb) <= conv.MAX_SMEM
            assert f"X({mt}, {bn}, {sb})" in lists[macro]
            assert f"m64n{bn}k8.f32.tf32.tf32" in header


def _like(is_cuda=True, dtype=torch.float32, shape=(1, 32, 16, 16), requires_grad=False):
    """What `route` reads of a tensor."""
    return SimpleNamespace(is_cuda=is_cuda, dtype=dtype, shape=shape,
                           requires_grad=requires_grad, dim=lambda: len(shape))


# route: (x, weight, stride, padding, grad mode) -> G?
ROUTES = [
    ("fp32 3x3", _like(), _like(shape=(64, 32, 3, 3)), 1, (1, 1), False, True),
    ("fp32 3x1", _like(), _like(shape=(64, 32, 3, 1)), 1, (1, 0), False, True),
    ("fp32 1x3", _like(), _like(shape=(64, 32, 1, 3)), 1, (0, 1), False, True),
    ("fp32 3x3 band", _like(), _like(shape=(64, 32, 3, 3)), 1, (0, 1), False, True),
    ("grad mode, nothing requires grad", _like(), _like(shape=(64, 32, 3, 3)), 1, (1, 1),
     True, True),
    ("training: x requires grad", _like(requires_grad=True), _like(shape=(64, 32, 3, 3)),
     1, (1, 1), True, False),
    ("training: weight requires grad", _like(),
     _like(shape=(64, 32, 3, 3), requires_grad=True), 1, (1, 1), True, False),
    ("no_grad, weight requires grad", _like(),
     _like(shape=(64, 32, 3, 3), requires_grad=True), 1, (1, 1), False, True),
    ("bf16", _like(dtype=torch.bfloat16), _like(dtype=torch.bfloat16, shape=(64, 32, 3, 3)),
     1, (1, 1), False, False),
    ("bf16 x, fp32 island weight", _like(dtype=torch.bfloat16), _like(shape=(64, 32, 3, 3)),
     1, (1, 1), False, False),
    ("cpu", _like(is_cuda=False), _like(is_cuda=False, shape=(64, 32, 3, 3)), 1, (1, 1),
     False, False),
    ("1x1", _like(), _like(shape=(64, 32, 1, 1)), 1, (0, 0), False, True),
    ("stride 2", _like(), _like(shape=(64, 32, 3, 3)), 2, (1, 1), False, False),
    ("1x1 stride 2", _like(), _like(shape=(64, 32, 1, 1)), 2, (0, 0), False, False),
    ("bf16 1x1", _like(dtype=torch.bfloat16), _like(dtype=torch.bfloat16, shape=(64, 32, 1, 1)),
     1, (0, 0), False, False),
    ("training 1x1: x requires grad", _like(requires_grad=True), _like(shape=(64, 32, 1, 1)),
     1, (0, 0), True, False),
    ("cpu 1x1", _like(is_cuda=False), _like(is_cuda=False, shape=(64, 32, 1, 1)), 1, (0, 0),
     False, False),
    ("weight of another input width", _like(), _like(shape=(64, 16, 3, 3)), 1, (1, 1),
     False, False),
    ("plan refuses: 1 output channel", _like(), _like(shape=(1, 32, 3, 3)), 1, (1, 1),
     False, False),
]


@pytest.mark.parametrize("case", ROUTES, ids=lambda c: c[0])
def test_route_table(case):
    _, x, w, stride, padding, grad, takes = case
    with torch.set_grad_enabled(grad):
        p = conv.route(x, w, stride, padding)
    assert (p is not None) == takes


def _conv_module(cin, cout, k, stride=1, padding=None, dtype=torch.float32, device="cuda"):
    m = layers.Conv(cin, cout, k, stride=stride, padding=padding)
    m.weight = nn.Parameter(torch.empty(m.weight.shape, device=device, dtype=dtype))
    m.bias = nn.Parameter(torch.empty(cout, device=device, dtype=dtype))
    return m


# Conv.forward on fake CUDA tensors: (name, x dtype, weight dtype, kernel,
# stride, padding, context, G?)
FORWARDS = [
    ("fp32 3x3", torch.float32, torch.float32, 3, 1, None, None, True),
    ("fp32 3x1", torch.float32, torch.float32, (3, 1), 1, None, None, True),
    ("fp32 1x3", torch.float32, torch.float32, (1, 3), 1, None, None, True),
    ("fp32 3x3 padding 0", torch.float32, torch.float32, 3, 1, 0, None, True),
    ("fp32 1x1", torch.float32, torch.float32, 1, 1, None, None, True),
    ("fp32 3x3 stride 2", torch.float32, torch.float32, 3, 2, None, None, False),
    ("fp32 1x1 stride 2", torch.float32, torch.float32, 1, 2, None, None, False),
    ("bf16 1x1", torch.bfloat16, torch.bfloat16, 1, 1, None, None, False),
    ("bf16", torch.bfloat16, torch.bfloat16, 3, 1, None, None, False),
    ("bf16 x, fp32 island weight", torch.bfloat16, torch.float32, 3, 1, None, None, False),
    ("int8 observe, bf16", torch.bfloat16, torch.bfloat16, 3, 1, None, "observe", False),
    ("prequantized weight, fp32 x", torch.float32, torch.float32, 3, 1, None, "prequant",
     False),
]


@pytest.mark.parametrize("case", FORWARDS, ids=lambda c: c[0])
def test_conv_forward_takes_g_only_on_its_route(case, monkeypatch):
    """Which path `Conv.forward` takes for an input, and what it counts: G
    (`conv.own_flops`) or F.conv2d (`conv.library_flops` for a float32
    CUDA result). Fake CUDA tensors: no card, no kernel; both paths are
    recorded instead of run."""
    _, x_dtype, w_dtype, k, stride, padding, ctx, takes = case
    calls = []

    def own(x, w_split, bias, kh, kw, ph, pw):
        calls.append(("own", (kh, kw, ph, pw)))
        return x.new_empty((x.shape[0], w_split.shape[0],
                            *conv.out_hw(x.shape[2], x.shape[3], kh, kw, ph, pw)))

    def library(x, w, b, stride, padding):
        calls.append(("library", None))
        return F.conv2d(x, w.to(x.dtype), None, stride=stride, padding=padding)

    monkeypatch.setattr(conv, "conv_tf32x3", own)
    monkeypatch.setattr(layers, "conv2d", library)
    monkeypatch.setattr(layers.Conv, "g_weight", lambda self: self.weight)
    monkeypatch.setattr(quant, "dequantize",  # shapes only: fake CUDA tensors take no slicing
                        lambda qw, k, dtype: qw[0].new_empty((qw[0].shape[0], k), dtype=dtype))
    before = trace.counters()
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        m = _conv_module(32, 64, k, stride, padding, dtype=w_dtype)
        if ctx == "prequant":
            m.w_q = torch.empty((64, 32 * 9), dtype=torch.int8, device="cuda")
            m.w_scale = torch.empty(64, device="cuda")
        x = torch.empty(1, 32, 16, 16, device="cuda", dtype=x_dtype)
        if ctx == "observe":
            with quant.observe():
                y = m(x)
        else:
            y = m(x)
        ph, pw = m.pads()
        assert y.shape[2:] == conv.out_hw(16, 16, *m.weight.shape[2:], ph, pw) or stride != 1
    after = trace.counters()
    assert [c[0] for c in calls] == ["own" if takes else "library"]
    if takes:
        assert calls[0][1] == (*m.weight.shape[2:], ph, pw)
    flops = 2 * y.numel() * 32 * m.weight.shape[2] * m.weight.shape[3]
    d_own = after.get("conv.own_flops", 0) - before.get("conv.own_flops", 0)
    d_lib = after.get("conv.library_flops", 0) - before.get("conv.library_flops", 0)
    float32 = y.dtype == torch.float32
    assert (d_own, d_lib) == ((flops, 0) if takes else (0, flops if float32 else 0))


def test_cpu_convs_stay_plain_and_uncounted():
    """On the CPU, Conv is F.conv2d (the path the JAX comparisons hold),
    neither launching nor counting anything."""
    _build.reset_launch_counts()
    before = trace.counters()
    m = layers.Conv(16, 32, 3)
    nn.init.normal_(m.weight)
    nn.init.zeros_(m.bias)
    x = torch.randn(1, 16, 8, 8)
    with torch.no_grad():
        y = m(x)
    assert torch.equal(y, F.conv2d(x, m.weight, m.bias, padding=1))
    after = trace.counters()
    assert after.get("conv.own_flops", 0) == before.get("conv.own_flops", 0)
    assert after.get("conv.library_flops", 0) == before.get("conv.library_flops", 0)
    assert _build.launch_counts["conv_tf32x3"] == _build.launch_counts["conv1x1_tf32x3"] == 0


def test_weight_split_is_cached_and_rebuilt_after_an_in_place_update():
    m = layers.Conv(8, 16, 3)
    with torch.no_grad():
        m.weight.copy_(torch.randn(m.weight.shape))
    first = m.g_weight()
    assert m.g_weight() is first
    assert torch.equal(first, conv.split_weight(m.weight.detach()))
    with torch.no_grad():
        m.weight.mul_(2.0)  # an optimizer step's kind of update: same storage
    second = m.g_weight()
    assert second is not first
    assert torch.equal(second, conv.split_weight(m.weight.detach()))
    m.load_state_dict({"weight": torch.randn(m.weight.shape), "bias": m.bias.detach()})
    assert torch.equal(m.g_weight(), conv.split_weight(m.weight.detach()))


def test_weight_split_of_an_inference_mode_weight_is_made_every_call():
    """A module made in inference mode has inference tensors, which track no
    version: its split is made anew on each call, so an in-place update
    (possible only in inference mode) is seen."""
    with torch.inference_mode():
        m = layers.Conv(8, 16, 3)
        m.weight.copy_(torch.randn(m.weight.shape))
        first = m.g_weight()
        assert torch.equal(first, conv.split_weight(m.weight))
        m.weight.mul_(2.0)
        assert torch.equal(m.g_weight(), conv.split_weight(m.weight))
        assert not torch.equal(m.g_weight(), first)


def test_custom_op_cpu_kernel_is_the_plain_version_and_the_fake_gives_the_shape():
    shape = (1, 40, 10, 12, 48, 3, 3, 1, 1)
    x, wt, bias = _operands(shape, seed=3)
    ws = conv.split_weight(wt)
    y = OPS.conv_tf32x3(x, ws, bias, 3, 3, 1, 1)
    assert torch.equal(y, conv.conv_tf32x3_plain(x, ws, bias, 3, 3, 1, 1))
    ws31 = conv.split_weight(wt[..., :1])
    meta = OPS.conv_tf32x3(x.to("meta"), ws31.to("meta"), None, 3, 1, 1, 0)
    assert meta.shape == (1, 48, 10, 12) and meta.device.type == "meta"
    # the wrapper sends meta tensors to the op
    out = conv.conv_tf32x3(x.to("meta"), ws.to("meta"), bias.to("meta"), 3, 3, 0, 1)
    assert out.shape == (1, 48, 8, 12)
    with pytest.raises(ValueError):
        OPS.conv_tf32x3(x.to("meta"), ws.to("meta"), None, 2, 2, 0, 0)


def test_opcheck():
    """Schema, autograd registration, fake tensor and AOT dispatch of the
    op on CPU tensors."""
    shape = (1, 20, 6, 8, 32, 3, 3, 1, 1)
    x, wt, bias = _operands(shape, seed=4)
    opcheck(OPS.conv_tf32x3.default, (x, conv.split_weight(wt), bias, 3, 3, 1, 1))
    opcheck(OPS.conv_tf32x3.default, (x, conv.split_weight(wt[:, :, :1]), None, 1, 3, 0, 1))
    opcheck(OPS.conv_tf32x3.default, (x, conv.split_weight(wt[:, :, 1:2, 1:2]), bias, 1, 1, 0,
                                      0))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 8, 6, 8)
    ws = conv.split_weight(torch.zeros(16, 8, 3, 3))
    with pytest.raises(ValueError):
        conv.conv_tf32x3(x.double(), ws, None, 3, 3, 1, 1)
    with pytest.raises(ValueError):
        conv.conv_tf32x3(x, ws, None, 3, 1, 1, 1)
    with pytest.raises(ValueError):
        conv.conv_tf32x3(x, ws, torch.zeros(15), 3, 3, 1, 1)
    with pytest.raises(ValueError):
        conv.conv_tf32x3(torch.zeros(1, 12, 6, 8), ws, None, 3, 3, 1, 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel G has no CPU path (chip_smoke.py's "
                    "phase_conv runs it at every routed S and XL shape)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_float64_on_card(cuda, shape):
    """G on the card within the float32-level bound of a float64 conv, at
    every instance, with a full grid and with one block walking every tile;
    the custom op's launch equals the direct one bitwise."""
    x, wt, bias = (t.to(cuda) for t in _operands(shape))
    kh, kw, ph, pw = shape[5:]
    ws = conv.split_weight(wt)
    for (mt, bn), sb in conv._INSTANCES.items():
        # one block an SM, and one block for every tile (the persistent loop)
        for cap in (0, 1):
            y = conv._kernel(x, ws, bias, kh, kw, ph, pw, conv.Plan(mt, bn, sb, 0, 0), cap)
            assert _rel_err(y, x, wt, bias, ph, pw) < BOUND, (mt, bn, cap)
    y = conv.conv_tf32x3(x, ws, bias, kh, kw, ph, pw)
    assert torch.equal(y, OPS.conv_tf32x3(x, ws, bias, kh, kw, ph, pw))


@pytest.mark.parametrize("shape", FLAT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flat_kernel_matches_float64_on_card(cuda, shape):
    """G's flat path on the card within the float32-level bound of a float64
    conv, at every flat instance, with a full grid and with one block
    walking every tile; the wrapper counts it as `conv1x1_tf32x3`, and the
    custom op's launch equals the direct one bitwise."""
    x, wt, bias = (t.to(cuda) for t in _operands(shape))
    ws = conv.split_weight(wt)
    for (mt, bn), sb in conv._FLAT_INSTANCES.items():
        for cap in (0, 1):
            y = conv._kernel(x, ws, bias, 1, 1, 0, 0, conv.Plan(mt, bn, sb, 0, 0, True), cap)
            assert _rel_err(y, x, wt, bias, 0, 0) < BOUND, (mt, bn, cap)
    before = dict(_build.launch_counts)
    y = conv.conv_tf32x3(x, ws, bias, 1, 1, 0, 0)
    torch.cuda.synchronize()
    assert _build.launch_counts["conv1x1_tf32x3"] == before["conv1x1_tf32x3"] + 1
    assert _build.launch_counts["conv_tf32x3"] == before["conv_tf32x3"]
    assert torch.equal(y, OPS.conv_tf32x3(x, ws, bias, 1, 1, 0, 0))
    with pytest.raises(ValueError):  # a spatial instance for a 1x1 kernel
        conv._kernel(x, ws, bias, 1, 1, 0, 0, conv.Plan(1, 128, 4, 0, 0))
