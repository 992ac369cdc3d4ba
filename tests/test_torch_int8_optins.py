"""The JAX package's two int8 opt-ins in the port, on the CPU (plain
versions of kernels E and F):

- `int8_attn` (s2m2_tpu/models/quant.py:357-404): the attention cores
  without PE in int8, `StereoEngine(..., int8_attn=True)`;
- `int8_acc_bf16` (quant.py:310-354, 462-465, 496-499): every int8 GEMM's
  accumulator rounded to bf16, `StereoEngine(..., int8_acc_bf16=True)`.

Checked: F's plain version against JAX's `sdpa_maybe_quantized` and E's
bf16-accumulator epilogue against JAX's int8 conv and linear at the same
scales; the observe list's length against JAX's on the golden fixture with
each opt-in; the drift from the fp32 reference within the JAX package's
bounds (tests/test_quant.py:186-191 with int8_attn, :211-218 with
int8_acc_bf16); the engine's rules. The exported program:
tests/test_torch_int8_optins_export.py; the disparity against JAX's with
its scales: tests/test_torch_int8_optins_jax.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2m2_torch.models import quant
from s2m2_torch.models.layers import Conv, Linear
from s2m2_torch.ops.int8_attention import int8_attention_plain
from s2m2_torch.runtime.engine import StereoEngine

from tests.test_torch_int8_engine import FIXTURES, GOLDEN, _fixture, _jax_model, \
    _port_model, _port_observe

torch.set_num_threads(2)
OPTINS = {"int8_attn": {"attn": True}, "int8_acc_bf16": {"acc_bf16": True}}


@pytest.mark.parametrize("shape,dtype", [((2, 4, 76, 16), "float32"),
                                         ((3, 1, 304, 32), "bfloat16"),
                                         ((2, 8, 40, 8), "bfloat16")])
def test_int8_attention_plain_matches_jax(shape, dtype):
    """(B, heads, N, d) q, k, v through JAX's core and, folded to (B *
    heads, N, d), through the port's plain version at the same scales:
    bf16 to the bit, float32 within 1e-6 (summation order of the
    softmax)."""
    from s2m2_tpu.models import quant as jq
    rng = np.random.default_rng(0)
    b, h, n, d = shape
    q, k, v = (rng.standard_normal(shape).astype(np.float32) * s for s in (1.0, 1.5, 2.0))
    scales = [float(np.abs(x).max()) / 127 for x in (q, k, v)]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq.set_int8_attn(True)
    try:
        with jq.quantized(scales):
            want = jq.sdpa_maybe_quantized(*(jnp.asarray(x, jd) for x in (q, k, v)))
    finally:
        jq.set_int8_attn(False)
    want = np.asarray(want.astype(jnp.float32))
    got = int8_attention_plain(*(torch.from_numpy(x).to(td).reshape(b * h, n, d)
                                 for x in (q, k, v)), *scales)
    assert got.dtype == td
    err = np.abs(got.float().reshape(shape).numpy() - want).max()
    assert err <= (0.0 if dtype == "bfloat16" else 1e-6), err


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("site", ["conv", "linear"])
def test_acc_bf16_site_matches_jax(site, dtype):
    """One int8 site with int8_acc_bf16 in both packages, same scale and
    weights (quantized inline): the same outputs to the bit (a 3x3 conv of
    48 channels, an implicit GEMM in the port, and a linear)."""
    from s2m2_tpu.models import layers as jl
    from s2m2_tpu.models import quant as jq
    rng = np.random.default_rng(1)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    if site == "conv":
        x = rng.standard_normal((2, 48, 12, 20)).astype(np.float32)
        w = (rng.standard_normal((64, 48, 3, 3)) * 0.1).astype(np.float32)
        jx, jw = x.transpose(0, 2, 3, 1), w.transpose(2, 3, 1, 0)
        mod, jfn = Conv(48, 64, 3), jl.conv2d
    else:
        x = rng.standard_normal((3, 40, 96)).astype(np.float32)
        w = (rng.standard_normal((80, 96)) * 0.1).astype(np.float32)
        jx, jw = x, w.T
        mod, jfn = Linear(96, 80), jl.linear
    bias = rng.standard_normal(w.shape[0]).astype(np.float32)
    s = float(np.abs(x).max()) / 127
    jq.set_acc_bf16(True)
    try:
        with jq.quantized([s]):
            want = jfn({"weight": jnp.asarray(jw, jd), "bias": jnp.asarray(bias, jd)},
                       jnp.asarray(jx, jd))
    finally:
        jq.set_acc_bf16(False)
    want = np.asarray(want.astype(jnp.float32))
    if site == "conv":
        want = want.transpose(0, 3, 1, 2)
    mod.weight.data = torch.from_numpy(w).to(td)
    mod.bias.data = torch.from_numpy(bias).to(td)
    with torch.inference_mode(), quant.quantized([s], acc_bf16=True):
        got = mod(torch.from_numpy(x).to(td))
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(), want)
    with torch.inference_mode(), quant.quantized([s]):
        plain = mod(torch.from_numpy(x).to(td)).float().numpy()
    assert not np.array_equal(plain, want)  # the opt-in changes the rounding


@pytest.mark.parametrize("optin", list(OPTINS))
def test_site_count_with_optin_matches_jax(optin):
    """The observe pass under the engine's policy records as many sites as
    the JAX package's with the same flag on: int8_attn adds three per
    attention core without PE (62 cores on this fixture), int8_acc_bf16
    none."""
    from s2m2_tpu.models import quant as jq
    from s2m2_tpu.models.s2m2 import forward
    jcfg, params, ja, jb = _jax_model(FIXTURES[0], bf16=True)

    def sites():
        def observer(p, a, b):  # a new function: eval_shape caches by function
            with jq.observe(skip_fp32=True) as obs:
                forward(p, a, b, jcfg)
            return jnp.stack(obs)
        return jax.eval_shape(observer, params, ja, jb).shape[0]

    base = sites()
    flag = jq.set_int8_attn if optin == "int8_attn" else jq.set_acc_bf16
    flag(True)
    try:
        want = sites()
    finally:
        flag(False)  # the flag may be defined after conftest's snapshot
    model, a, b = _port_model(FIXTURES[0], bf16=True)
    got = _port_observe(model, a, b, skip_fp32=True, **OPTINS[optin])
    assert len(got) == want
    assert want - base == (3 * 62 if optin == "int8_attn" else 0)
    assert sum(r["kind"] == "gemm_site" for r in quant.last_log()) > 0


# The JAX package's bounds: tests/test_quant.py:186-191 (its int8 case runs
# with int8_attn on) and :211-218 (int8_acc_bf16), and whether the pair
# alone is held to it too (all but neg/upsample with int8_attn, whose pair
# reads 0.0852 here: ROADMAP Queue 3 item 9).
DRIFT = [("s2m2_c32_ntr1.npz", "int8_attn", 0.01, True),
         ("s2m2_c32_ntr1_neg_up.npz", "int8_attn", 0.08, False),
         ("s2m2_c32_ntr1.npz", "int8_acc_bf16", 0.02, True),
         ("s2m2_c32_ntr1_neg_up.npz", "int8_acc_bf16", 0.09, True)]


@pytest.mark.parametrize("fixture,optin,bound,pair_alone", DRIFT)
def test_optin_drift_on_golden(fixture, optin, bound, pair_alone):
    """An int8 engine with the opt-in, calibrated on the fixture's pair:
    mean |disp - fp32 reference| below the JAX package's bound, on the pair
    alone as the JAX test reads it (`pair_alone`), and as the mean over five
    calibrated runs: the pair itself and the pair with one image times 1 +
    1e-6 or 1 - 1e-6 (each image in turn). On the neg/upsample fixture one
    such change of the input moves the drift of the plain int8 engine
    between 0.058 and 0.091 px, and of int8_attn between 0.052 and 0.089
    (the pair itself: 0.0632 and 0.0852), so one run does not measure it
    there (ROADMAP Queue 3 item 9; the JAX package's own reading of that
    pair on its fused-OT route is 0.0855: tests/torch_int8_drift_readings.py)."""
    cfg, img0, img1, ref = _fixture(fixture)
    up, down = np.float32(1 + 1e-6), np.float32(1 - 1e-6)
    runs = []
    for a, b in ((img0, img1), (img0 * up, img1), (img0 * down, img1), (img0, img1 * up),
                 (img0, img1 * down)):
        eng = StereoEngine(cfg, checkpoint=os.path.join(GOLDEN, fixture), precision="int8",
                           device="cpu", **{optin: True})
        disp = eng.forward_padded(a, b)[0].numpy()  # calibrates on the pair
        runs.append(float(np.abs(disp - ref).mean()))
    assert not pair_alone or runs[0] < bound, (runs, bound)
    assert np.mean(runs) < bound, (runs, bound)


def test_optins_need_an_int8_precision():
    cfg = _fixture(FIXTURES[0])[0]
    for optin in OPTINS:
        with pytest.raises(ValueError, match="need an int8 precision"):
            StereoEngine(cfg, precision="bf16", device="cpu", **{optin: True})
    eng = StereoEngine(cfg, precision="int8a", device="cpu", int8_attn=True,
                       int8_acc_bf16=True)
    assert eng.quant_policy == dict(aligned=True, skip_fp32=True, residency=False, attn=True,
                                    acc_bf16=True)


def test_int8_attn_quantizes_under_int8a():
    """JAX's `sdpa_maybe_quantized` does not consult the site policy, so an
    int8a engine (no GEMM of this c32 model is 128-aligned but the shared
    ones) still takes the attention cores' sites."""
    cfg, img0, img1, _ = _fixture(FIXTURES[0])
    eng = StereoEngine(cfg, checkpoint=os.path.join(GOLDEN, FIXTURES[0]), precision="int8a",
                       device="cpu", int8_attn=True)
    plain = StereoEngine(cfg, checkpoint=os.path.join(GOLDEN, FIXTURES[0]),
                         precision="int8a", device="cpu")
    assert len(eng.calibrate(img0, img1)) == len(plain.calibrate(img0, img1)) + 3 * 62
    disp = eng.forward_padded(img0, img1)[0].numpy()
    assert np.isfinite(disp).all()
    assert sum(r["kind"] == "attention" for r in quant.last_log()) == 62
