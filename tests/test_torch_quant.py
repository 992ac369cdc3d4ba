"""The port's int8 sites (s2m2_torch/models/quant.py) against the JAX
package's (s2m2_tpu/models/quant.py), site by site on the same seeded
inputs and scales; prequantized weights against `quantize_params_tree`;
and kernel E's plain `probe_chain` against the TPU probe's own Pallas
kernels run in interpret mode.

Tolerance of the site tests: the int32 accumulators of the two packages are
equal where the float inputs are, so the bf16 outputs agree to 1 bf16 ulp
(bit-equal in practice); the per-head projection runs in float32 behind a
float attention core, to 1e-5 of the output's scale. The JAX side runs
eagerly: under jit, XLA rewrites the weight quantization's w / s_w as
w * (1 / s_w), which moves a few int8 weights by one.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from s2m2_tpu.models import layers as jlayers
from s2m2_tpu.models import quant as jquant
from s2m2_torch.models import quant
from s2m2_torch.models.attention import CrossAttn, SelfAttn
from s2m2_torch.models.layers import Conv, Linear
from s2m2_torch.ops import int8_gemm as ig

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bf16_ulp_close(got, want):
    """|got - want| <= one bf16 ulp of the larger of the two, elementwise."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    big = np.maximum(np.maximum(np.abs(g), np.abs(w)), 1e-30)
    ulp = np.exp2(np.floor(np.log2(big)) - 7)
    bad = np.abs(g - w) > ulp
    assert not bad.any(), f"{bad.sum()} of {bad.size} outside 1 bf16 ulp, max |diff| " \
                          f"{np.abs(g - w).max()}"


def _both(jax_call, torch_call, **ctx):
    """Observe in both packages (same amax), then run both quantized with
    the JAX scales; returns (port outputs, JAX outputs, scales)."""
    def observer():
        with jquant.observe(**ctx) as obs:
            jax_call()
        return [jnp.asarray(0.0)] + obs  # never an empty list

    jobs = jax.jit(observer)()[1:]
    with torch.inference_mode(), quant.observe(**ctx) as tobs:
        torch_call()
    assert len(tobs) == len(jobs)
    np.testing.assert_allclose([float(o) for o in tobs], [float(o) for o in jobs],
                               rtol=1e-6)
    scales = [float(o) / 127.0 for o in jobs]
    qctx = {k: v for k, v in ctx.items() if k != "percentile"}
    with jquant.quantized(scales, **qctx):
        want = jax_call()  # eager: under jit XLA turns w / s_w into w * (1 / s_w)
    with torch.inference_mode(), quant.quantized(scales, **qctx):
        got = torch_call()
    return got, want, scales


def _linear(rng, cin, cout, bias=True):
    w = (rng.standard_normal((cin, cout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.01).astype(np.float32) if bias else None
    jp = {"weight": jnp.asarray(w, jnp.bfloat16)}
    mod = Linear(cin, cout, bias)
    mod.weight.data = torch.from_numpy(w.T.copy()).bfloat16()
    if bias:
        jp["bias"] = jnp.asarray(b, jnp.bfloat16)
        mod.bias.data = torch.from_numpy(b).bfloat16()
    return jp, mod


def test_linear_site_matches_jax(rng):
    jp, mod = _linear(rng, 64, 48)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    got, want, _ = _both(lambda: jlayers.linear(jp, xj), lambda: mod(xt))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 7, 48)
    _bf16_ulp_close(got, want)


@pytest.mark.parametrize("k,stride,cin", [(1, 1, 32), (3, 1, 24), (3, 2, 40)],
                         ids=["1x1", "3x3", "3x3-stride2"])
def test_conv_site_matches_jax(rng, k, stride, cin):
    cout = 16
    w = (rng.standard_normal((k, k, cin, cout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.01).astype(np.float32)
    jp = {"weight": jnp.asarray(w, jnp.bfloat16), "bias": jnp.asarray(b, jnp.bfloat16)}
    mod = Conv(cin, cout, k, stride=stride)
    mod.weight.data = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).bfloat16()
    mod.bias.data = torch.from_numpy(b).bfloat16()
    x = rng.standard_normal((2, 9, 11, cin)).astype(np.float32)  # NHWC
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).bfloat16()
    got, want, _ = _both(lambda: jlayers.conv2d(jp, xj, stride=stride), lambda: mod(xt))
    _bf16_ulp_close(got.permute(0, 2, 3, 1), want)


def test_shared_input_is_one_site(rng):
    mods = [_linear(rng, 32, 32, bias=(n == "v")) for n in "qkv"]
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()

    def jcall():
        xs = jquant.share_gemm_input(xj)
        return [jlayers.linear(jp, xs) for jp, _ in mods]

    def tcall():
        xs = quant.share_gemm_input(xt)
        return [mod(xs) for _, mod in mods]

    got, want, scales = _both(jcall, tcall)
    assert len(scales) == 1
    for g, w in zip(got, want):
        _bf16_ulp_close(g, w)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_sliced_head_projection_matches_jax(rng, cross):
    """A multi-head scanline attention: one shared q/k/v site, q/k/v/proj
    quantized as whole weights, one proj site per head (JAX
    `_attn_4d_sliced`), in float32 behind the float attention core."""
    from s2m2_tpu.models.attention import _attn_4d_sliced
    c, nh = 64, 2
    ws = {n: (rng.standard_normal((c, c)) * 0.1).astype(np.float32) for n in
          ("q", "k", "v", "proj")}
    bv = (rng.standard_normal(c) * 0.01).astype(np.float32)
    jp = {n: {"weight": jnp.asarray(w)} for n, w in ws.items()}
    jp["v"]["bias"] = jnp.asarray(bv)
    attn = (CrossAttn if cross else SelfAttn)(c, nh)
    attn.sliced = True
    for n, w in ws.items():
        getattr(attn, n).weight.data = torch.from_numpy(w.T.copy())
    attn.v.bias.data = torch.from_numpy(bv)
    z = rng.standard_normal((2, 3, 16, c)).astype(np.float32)  # (2B, R, W, C)
    zj, zt = jnp.asarray(z), torch.from_numpy(z.reshape(6, 16, c))
    got, want, scales = _both(
        lambda: _attn_4d_sliced(jp, zj, nh, cross_b0=1 if cross else None),
        lambda: attn(zt))
    assert len(scales) == 1 + nh
    want = np.asarray(want).reshape(6, 16, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the sites quantize whole weights: prequantize_linear equals the offline form
    with quant.observe():
        qw = quant.prequantize_linear(attn.proj)
    np.testing.assert_array_equal(
        qw[0][:, :c].numpy().T,
        np.asarray(jquant._quantize_weight(jp["proj"]["weight"], (0,))[0]))


def test_residual_store_load_matches_jax(rng):
    z = rng.standard_normal((4, 6, 32)).astype(np.float32) * 3
    zj, zt = jnp.asarray(z, jnp.bfloat16), torch.from_numpy(z).bfloat16()
    got, want, scales = _both(
        lambda: jquant.residual_load(jquant.residual_store(zj)),
        lambda: quant.residual_load(quant.residual_store(zt)), residency=True)
    assert len(scales) == 1 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    with torch.inference_mode(), quant.quantized([]):  # no residency: identity
        assert quant.residual_store(zt) is zt


def test_small_and_fp32_sites_stay_float(rng):
    _, head = _linear(rng, 64, 4)  # cout < 8
    _, shallow = _linear(rng, 8, 32)  # reduction depth < 16
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32)).bfloat16()
    with torch.inference_mode(), quant.observe() as obs:
        head(x)
        shallow(x[:, :8])
    assert obs == []
    fp32 = Linear(64, 32)
    fp32.weight.data = torch.randn(32, 64)
    fp32.bias.data = torch.zeros(32)
    with torch.inference_mode(), quant.observe(skip_fp32=True) as obs:
        fp32(x)
    assert obs == []


def test_site_count_mismatch_raises(rng):
    _, mod = _linear(rng, 32, 32)
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32)).bfloat16()
    with pytest.raises(ValueError, match="diverged"):
        with torch.inference_mode(), quant.quantized([]):
            mod(x)
    with pytest.raises(ValueError, match="diverged"):
        with torch.inference_mode(), quant.quantized([0.1, 0.1]):
            mod(x)


@pytest.fixture(scope="module")
def c32_weights():
    """JAX-initialised c32/NTR1 weights (seed 3): (JAX params, state dict)."""
    from s2m2_tpu.config import ModelConfig as JaxConfig
    from s2m2_tpu.models.init import init_params as jax_init
    from s2m2_tpu.tools.convert_checkpoint import flatten
    from s2m2_torch.tools.convert import from_jax
    params = jax_init(JaxConfig(feature_channels=32, num_transformer=1, refine_iter=1),
                      seed=3)
    return params, from_jax({k: np.asarray(v) for k, v in flatten(params).items()})


@pytest.mark.parametrize("skip_fp32", [True])
def test_quantize_model_matches_quantize_params_tree(c32_weights, skip_fp32):
    """Every prequantized module against the JAX tree's int8 leaf, under the
    engine's cast policy (bf16 with float32 islands, skip_fp32): the same
    set of weights, w_q bit-equal, w_scale to rtol 1e-6."""
    from s2m2_tpu.config import ModelConfig as JaxConfig
    from s2m2_tpu.runtime.engine import cast_params as jax_cast
    from s2m2_tpu.runtime.engine import fp32_keep_paths as jax_keep
    from s2m2_tpu.tools.convert_checkpoint import flatten
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.models.s2m2 import S2M2
    from s2m2_torch.runtime.engine import cast_params, fp32_keep_paths

    kw = dict(feature_channels=32, num_transformer=1, refine_iter=1)
    params, state = c32_weights
    model = S2M2(ModelConfig(**kw))
    model.load_state_dict(state)
    if skip_fp32:
        params = jax_cast(params, jnp.bfloat16, jax_keep(JaxConfig(**kw)))
        cast_params(model, torch.bfloat16, fp32_keep_paths(ModelConfig(**kw)))
    # eagerly, as the JAX engine calls it (under jit XLA may round w / s_w
    # otherwise)
    tree = flatten(jquant.quantize_params_tree(params, aligned=False, skip_fp32=skip_fp32))
    want = {k[:-len(".w_scale")] for k in tree if k.endswith(".w_scale")}
    n = quant.quantize_model(model, aligned=False, skip_fp32=skip_fp32)
    mods = dict(model.named_modules())
    got = {name for name, m in mods.items() if quant.prequant_of(m) is not None}
    assert got == want and n == len(want) > 50
    for name in want:
        w_q, s_w = quant.prequant_of(mods[name])
        jw = np.asarray(tree[name + ".weight"])
        k = int(np.prod(jw.shape[:-1]))
        if jw.ndim == 4:  # (kh, kw, I, O) -> (O, I*kh*kw)
            jw = jw.transpose(3, 2, 0, 1).reshape(jw.shape[3], -1)
        else:
            jw = jw.T
        np.testing.assert_array_equal(w_q[:, :k].numpy(), jw, err_msg=name)
        assert not w_q[:, k:].any()
        np.testing.assert_allclose(s_w.numpy(), np.asarray(tree[name + ".w_scale"]).ravel(),
                                   rtol=1e-6, err_msg=name)


def _probe():
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_int8", os.path.join(ROOT, "scripts", "probe_pallas_int8.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_probe_chain_plain_matches_pallas_probe(kind):
    """Kernel E's plain version against the probe's own kernel bodies at its
    (8, 304, 384), inputs and weight scaling. int8: bit-equal (every
    product is exact and both round alike). bf16: the float32 sums differ
    in order, so 8 chained bf16 roundings drift; within 2e-2 of max|ref|."""
    from jax.experimental import pallas as pl
    probe = _probe()
    g, w, c = probe.G, probe.W, probe.C
    x = np.array(jnp.asarray(np.random.default_rng(0).standard_normal((g, w, c)) * 0.1,
                             jnp.bfloat16).astype(jnp.float32))
    rng = np.random.default_rng(1)
    w_bf = np.array(jnp.asarray(rng.standard_normal((c, c)) * 0.05, jnp.bfloat16)
                    .astype(jnp.float32))
    w_i8 = rng.integers(-127, 128, (c, c)).astype(np.int8)
    body, wj, wt = ((probe._kernel_int8, jnp.asarray(w_i8), torch.from_numpy(w_i8))
                    if kind == "int8" else
                    (probe._kernel_bf16, jnp.asarray(w_bf, jnp.bfloat16),
                     torch.from_numpy(w_bf).bfloat16()))
    want = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct((g, w, c), jnp.bfloat16),
                          interpret=True)(jnp.asarray(x, jnp.bfloat16), wj)
    want = np.asarray(want.astype(jnp.float32))
    got = ig.probe_chain(torch.from_numpy(x).bfloat16(), wt, kind).float().numpy()
    if kind == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
