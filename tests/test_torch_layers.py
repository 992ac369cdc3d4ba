"""s2m2_torch layer primitives against s2m2_tpu.models.layers on shared
numpy inputs (the cases of tests/test_layers.py), float32, atol 1e-5."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from s2m2_tpu.models import layers as jl
from s2m2_torch.models import layers as tl

torch.set_num_threads(2)
ATOL = 1e-5


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x_nhwc, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _close(got_torch_nchw, want_jax_nhwc, atol=ATOL):
    np.testing.assert_allclose(_nhwc(got_torch_nchw), np.asarray(want_jax_nhwc),
                               atol=atol)


@pytest.mark.parametrize("kh,kw,stride,cin,cout", [
    (1, 1, 1, 3, 16), (3, 3, 1, 8, 8), (3, 3, 2, 8, 16), (5, 5, 2, 16, 8),
    (3, 1, 1, 4, 5), (1, 3, 1, 4, 5)])
def test_conv2d(rng, kh, kw, stride, cin, cout):
    x = rng.standard_normal((2, 12, 10, cin), dtype=np.float32)
    w = rng.standard_normal((kh, kw, cin, cout), dtype=np.float32) * 0.1  # HWIO
    b = rng.standard_normal((cout,), dtype=np.float32)
    want = jl.conv2d({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                     jnp.asarray(x), stride=stride)
    got = tl.conv2d(_nchw(x), torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()),
                    torch.from_numpy(b), stride=stride)
    _close(got, want)


@pytest.mark.parametrize("k,stride,pad", [(2, 2, 0), (3, 1, 1), (1, 1, 0), (3, 2, 1)])
def test_conv_transpose2d(rng, k, stride, pad):
    cin, cout = 6, 5
    x = rng.standard_normal((2, 8, 9, cin), dtype=np.float32)
    w = rng.standard_normal((k, k, cin, cout), dtype=np.float32) * 0.2  # (kh,kw,I,O)
    b = rng.standard_normal((cout,), dtype=np.float32)
    want = jl.conv_transpose2d({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                               jnp.asarray(x), stride=stride, padding=pad)
    got = tl.conv_transpose2d(_nchw(x),
                              torch.from_numpy(np.transpose(w, (2, 3, 0, 1)).copy()),
                              torch.from_numpy(b), stride=stride, padding=pad)
    _close(got, want)


def test_linear_and_fp32_island(rng):
    x = rng.standard_normal((3, 7, 16), dtype=np.float32)
    w = rng.standard_normal((16, 24), dtype=np.float32) * 0.2  # (in, out)
    b = rng.standard_normal((24,), dtype=np.float32)
    want = jl.linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x))
    wt, bt = torch.from_numpy(w.T.copy()), torch.from_numpy(b)
    got = tl.linear(torch.from_numpy(x), wt, bt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # float32 weights upcast a bf16 input: the layer computes in float32
    got16 = tl.linear(torch.from_numpy(x).bfloat16(), wt, bt)
    assert got16.dtype == torch.float32
    # bf16 weights keep a bf16 input in bf16
    assert tl.linear(torch.from_numpy(x).bfloat16(), wt.bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("offset", [0.0, 100.0])
def test_group_norm(rng, offset):
    """Two-pass statistics. At mean ~100 both packages stay within 2e-3 of
    the float64 truth (the bound of tests/test_layers.py, where a one-pass
    E[x^2]-mean^2 form errs by 86); against each other they differ by the
    float32 rounding of terms of size |mean|, so the 1e-5 tolerance scales
    with 1 + |mean|."""
    c, g = 32, 8
    x = rng.standard_normal((2, 6, 5, c), dtype=np.float32) + np.float32(offset)
    w = rng.standard_normal((c,), dtype=np.float32)
    b = rng.standard_normal((c,), dtype=np.float32)
    want = jl.group_norm({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                         jnp.asarray(x), num_groups=g)
    got = tl.group_norm(_nchw(x), torch.from_numpy(w), torch.from_numpy(b), g)
    _close(got, want, atol=ATOL * (1 + offset))
    xd = x.astype(np.float64).reshape(2, 6, 5, g, c // g)
    md = xd.mean(axis=(1, 2, 4), keepdims=True)
    vd = ((xd - md) ** 2).mean(axis=(1, 2, 4), keepdims=True)
    truth = ((xd - md) / np.sqrt(vd + 1e-5)).reshape(2, 6, 5, c) * w + b
    np.testing.assert_allclose(_nhwc(got), truth, atol=2e-3)


def test_layer_norm(rng):
    x = rng.standard_normal((3, 7, 16), dtype=np.float32)
    np.testing.assert_allclose(tl.layer_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.layer_norm(jnp.asarray(x))), atol=ATOL)
    w = rng.standard_normal((16,), dtype=np.float32)
    b = rng.standard_normal((16,), dtype=np.float32)
    want = jl.layer_norm(jnp.asarray(x), {"weight": jnp.asarray(w),
                                          "bias": jnp.asarray(b)})
    got = tl.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("k", [2, (1, 2)])
def test_avg_pool(rng, k):
    x = rng.standard_normal((2, 8, 6, 4), dtype=np.float32)
    _close(tl.avg_pool2d(_nchw(x), k), jl.avg_pool2d(jnp.asarray(x), k))


def test_resampling(rng):
    x = rng.standard_normal((2, 5, 7, 3), dtype=np.float32)
    _close(tl.upsample2x_bilinear(_nchw(x)), jl.upsample2x_bilinear(jnp.asarray(x)))
    _close(tl.upsample_nearest(_nchw(x), 4), jl.upsample_nearest(jnp.asarray(x), 4),
           atol=0)
    _close(tl.replicate_pad(_nchw(x), 1), jl.replicate_pad(jnp.asarray(x), 1), atol=0)


@pytest.mark.parametrize("c", [1, 3])
def test_unfold9(rng, c):
    x = rng.standard_normal((2, 6, 7, c), dtype=np.float32)
    _close(tl.unfold9(_nchw(x)), jl.unfold9(jnp.asarray(x)), atol=0)


def test_pointwise(rng):
    x = rng.standard_normal((128,), dtype=np.float32) * 3
    np.testing.assert_allclose(tl.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.gelu(jnp.asarray(x))), atol=1e-6)
    p = rng.uniform(0, 1, 100).astype(np.float32)
    for eps in (1e-1, 1e-2):
        np.testing.assert_allclose(tl.logit(torch.from_numpy(p), eps).numpy(),
                                   np.asarray(jl.logit(jnp.asarray(p), eps)), atol=ATOL)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_logsumexp_stable(rng, dim):
    x = rng.standard_normal((2, 5, 6), dtype=np.float32) * 10
    x[0, 0, 0] = -1e4  # the masked value of the OT matcher
    got = tl.logsumexp_stable(torch.from_numpy(x), dim)
    want = jl.logsumexp_stable(jnp.asarray(x), axis=dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_pe_tables_and_contract_match_jax(rng):
    from s2m2_tpu.models import pe as jpe
    from s2m2_torch.models import pe as tpe
    h, w = 3, 5
    ty, tx = tpe.pe_tables(h, w, 32)
    jty, jtx = jpe.pe_tables(h, w, 32)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jty))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jtx))
    attn = rng.uniform(0, 1, (2, h * w, h * w)).astype(np.float32)
    got = tpe.pe_contract(torch.from_numpy(attn), ty, tx, h, w)
    want = jpe.pe_contract(jnp.asarray(attn), jty, jtx, h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cost_volume_lookup_matches_jax(rng):
    """Two-tap gather against the JAX hat reduction, with positions off both
    ends of the candidate axis (each tap zero-padded on its own)."""
    from s2m2_tpu.models import cost_volume as jcv
    from s2m2_torch.models import cost_volume as tcv
    cv = rng.standard_normal((1, 3, 16, 16)).astype(np.float32)
    disp = rng.uniform(-6, 22, (1, 3, 16, 1)).astype(np.float32)  # (B,H,W,1)
    want = jcv.cost_volume_lookup(jcv.make_cost_volume(jnp.asarray(cv)),
                                  jnp.asarray(disp))
    got = tcv.cost_volume_lookup(tcv.make_cost_volume(torch.from_numpy(cv)),
                                 torch.from_numpy(np.ascontiguousarray(
                                     disp.transpose(0, 3, 1, 2))))
    for g, wnt in zip(got, want):
        _close(g, wnt)
