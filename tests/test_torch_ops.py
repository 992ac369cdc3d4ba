"""Plain PyTorch versions of the s2m2_torch kernels against the JAX package's
Pallas kernels run in interpret mode (the CUDA kernels themselves are held
against these plain versions in tests/test_torch_kernels.py)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from s2m2_torch.ops import flash_attention as fa
from s2m2_torch.ops import sinkhorn

torch.set_num_threads(2)


def _pair(rng, shape, dtype):
    """The same seeded numpy array as a (jax, torch) pair in `dtype`."""
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)


# attention: atol 2e-5 in float32 (tests/test_flash.py); in bfloat16 the
# outputs round to 8 mantissa bits, so 2e-2 (tests/test_flash.py::test_bf16_path)
ATTN_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 48, 32), (4, 40, 16), (2, 76, 384),
                                   (2, 40, 256), (2, 70, 24)])
def test_scanline_attention_plain_matches_pallas(rng, shape, dtype):
    from s2m2_tpu.ops.flash_attention import scanline_attention as jax_attn
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, shape, dtype) for _ in range(3))
    want = jax_attn(qj, kj, vj, interpret=True)
    got = fa.scanline_attention(qt, kt, vt)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 48, 32), (4, 40, 16), (2, 76, 384),
                                   (2, 40, 256), (2, 70, 24)])
def test_scanline_cross_attention_plain_matches_pallas(rng, shape, dtype):
    from s2m2_tpu.ops.flash_attention import scanline_cross_attention as jax_cross
    pairs = [_pair(rng, shape, dtype) for _ in range(6)]
    want = jax_cross(*(p[0] for p in pairs), interpret=True)
    got = fa.scanline_cross_attention(*(p[1] for p in pairs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=ATTN_ATOL[dtype])


@pytest.mark.parametrize("use_positivity", [True, False])
def test_fused_correlation_ot_plain_matches_pallas(rng, use_positivity):
    from s2m2_tpu.ops.sinkhorn import fused_correlation_ot as jax_ot
    (f0j, f0t), (f1j, f1t) = (_pair(rng, (1, 4, 32, 16), "float32") for _ in range(2))
    prob_w, cv_w = jax_ot(f0j, f1j, ot_iter=3, use_positivity=use_positivity,
                          interpret=True)
    prob, cv = sinkhorn.fused_correlation_ot(f0t, f1t, ot_iter=3,
                                             use_positivity=use_positivity)
    # tolerances of tests/test_sinkhorn_kernel.py
    np.testing.assert_allclose(cv.numpy(), np.asarray(cv_w), atol=2e-4)
    np.testing.assert_allclose(prob.numpy(), np.asarray(prob_w), rtol=1e-4, atol=1e-6)
