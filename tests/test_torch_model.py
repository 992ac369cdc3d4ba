"""The s2m2_torch forward against the reference-torch golden fixtures and
against the JAX package's forward, plus module-level parity for the modules
that hold a kernel (attention blocks, the OT matcher). The forward tests run
with the fused BasicAttnBlock off (ids as before) and on (ids "-fused")."""
import glob
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from s2m2_torch.config import ModelConfig
from s2m2_torch.models.s2m2 import S2M2
from s2m2_torch.runtime.engine import cast_params, fp32_keep_paths
from s2m2_torch.tools.convert import from_jax, load_npz

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FIXTURES = sorted(glob.glob(os.path.join(GOLDEN, "s2m2_*.npz")))


def _with_fused(args, ids):
    """Each case unfused (its id unchanged), then fused (id + "-fused")."""
    return ([pytest.param(*a, False, id=i) for a, i in zip(args, ids)]
            + [pytest.param(*a, True, id=f"{i}-fused") for a, i in zip(args, ids)])


def _fixture(path, fused_block=False):
    with np.load(path) as z:
        meta = list(z["__meta"])
        imgs = [np.transpose(z[k], (0, 2, 3, 1)) for k in ("__img0", "__img1")]
        refs = [np.transpose(z[k], (0, 2, 3, 1)) for k in ("__disp", "__occ", "__conf")]
    cfg = ModelConfig(feature_channels=int(meta[0]), num_transformer=int(meta[1]),
                      refine_iter=int(meta[2]),
                      use_positivity=bool(meta[3]) if len(meta) > 3 else True,
                      output_upsample=bool(meta[4]) if len(meta) > 4 else False)
    model = S2M2(cfg, fused_block=fused_block)
    model.load_state_dict(load_npz(path))
    return cfg, model.eval(), imgs, refs


def _assert_parity(outs, refs):
    """The tolerances of tests/test_model_parity.py:46-50."""
    disp, occ, conf = (o.float().numpy() for o in outs)
    np.testing.assert_allclose(disp, refs[0], atol=2e-2)
    np.testing.assert_allclose(occ, refs[1], atol=2e-3)
    np.testing.assert_allclose(conf, refs[2], atol=2e-3)
    epe = np.abs(disp - refs[0]).mean()
    assert epe < 1e-3, f"EPE vs reference {epe}"


@pytest.mark.parametrize("path,fused_block", _with_fused(
    [(p,) for p in FIXTURES], [os.path.basename(p) for p in FIXTURES]))
def test_forward_matches_reference(path, fused_block):
    _, model, imgs, refs = _fixture(path, fused_block)
    with torch.inference_mode():
        outs = model(*(torch.from_numpy(i) for i in imgs))
    _assert_parity(outs, refs)


def test_stacked_mrt_multihead_matches_reference():
    from s2m2_torch.models.mrt import StackedMRT
    with np.load(os.path.join(GOLDEN, "mrt_c32_ntr1_h2.npz")) as z:
        data = {k: z[k] for k in z.files}
    c, ntr, heads = (int(v) for v in data.pop("__meta"))
    zs = [torch.from_numpy(data.pop(f"__z{i}")) for i in range(4)]  # NCHW already
    ref = data.pop("__out")
    mrt = StackedMRT([c, c, 2 * c], ntr, heads)
    mrt.load_state_dict(from_jax(data))  # keys uformer_list.<i>.*
    with torch.inference_mode():
        got = mrt(*zs)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)


@pytest.mark.parametrize("fused_block", [False, True], ids=["unfused", "fused"])
def test_forward_matches_jax_forward(fused_block):
    """Same JAX-initialised c32/NTR1 weights and the same 64x96 pair through
    both packages (the JAX forward runs its default XLA path on the CPU)."""
    from s2m2_tpu.config import ModelConfig as JaxConfig
    from s2m2_tpu.models.init import init_params as jax_init
    from s2m2_tpu.models.s2m2 import forward as jax_forward
    from s2m2_tpu.tools.convert_checkpoint import flatten

    cfg = ModelConfig(feature_channels=32, num_transformer=1, refine_iter=2)
    params = jax_init(JaxConfig(feature_channels=32, num_transformer=1, refine_iter=2),
                      seed=5)
    rng = np.random.default_rng(5)
    img0 = rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
    img1 = np.roll(img0, -4, axis=2) + rng.normal(0, 2, img0.shape).astype(np.float32)
    want = jax.jit(lambda p, a, b: jax_forward(p, a, b, JaxConfig(
        feature_channels=32, num_transformer=1, refine_iter=2)))(
        params, jnp.asarray(img0), jnp.asarray(img1))
    model = S2M2(cfg, fused_block=fused_block)
    model.load_state_dict(from_jax({k: np.asarray(v) for k, v in flatten(params).items()}))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(img0), torch.from_numpy(img1))
    _assert_parity(got, [np.asarray(w) for w in want])


DRIFT_FIXTURES = ["s2m2_c32_ntr1.npz", "s2m2_c32_ntr1_neg_up.npz"]


@pytest.mark.parametrize("fixture,fused_block", _with_fused(
    [(f,) for f in DRIFT_FIXTURES], DRIFT_FIXTURES))
def test_bf16_drift_vs_fp32(fixture, fused_block):
    """bf16 weights and activations with the engine's fp32 islands stay within
    the drift bounds of tests/test_model_parity.py:115."""
    cfg, model, imgs, refs = _fixture(os.path.join(GOLDEN, fixture), fused_block)
    cast_params(model, torch.bfloat16, fp32_keep_paths(cfg))
    with torch.inference_mode():
        disp, _, _ = model(*(torch.from_numpy(i).bfloat16() for i in imgs))
    epe = np.abs(disp.float().numpy() - refs[0]).mean()
    bound = 0.04 if cfg.output_upsample else 0.01
    assert epe < bound, f"bf16 EPE vs reference fp32 {epe} (bound {bound})"


@pytest.mark.parametrize("heads", [1, 2])
def test_basic_attn_block_matches_jax(rng, heads):
    """A scanline block (cross + FFN + self + FFN): the attention kernels'
    callers against the JAX block on the same weights and input."""
    from s2m2_tpu.models.attention import basic_attn_block
    from s2m2_tpu.models.init import _Rng, _basic_attn_block
    from s2m2_tpu.tools.convert_checkpoint import flatten
    from s2m2_torch.models.attention import BasicAttnBlock

    p = _basic_attn_block(_Rng(7), 32, heads, 1)
    z = rng.standard_normal((2, 3, 10, 32)).astype(np.float32)  # (2B, H, W, C)
    want = basic_attn_block(p, jnp.asarray(z), heads)
    blk = BasicAttnBlock(32, heads)
    blk.load_state_dict(from_jax({k: np.asarray(v) for k, v in flatten(p).items()}))
    with torch.inference_mode():
        got = blk(torch.from_numpy(np.ascontiguousarray(z.transpose(0, 3, 1, 2))))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               atol=2e-5)


@pytest.mark.parametrize("use_positivity", [True, False])
def test_disp_init_matches_jax(rng, use_positivity):
    """The OT matcher around kernel C: disparity, confidence, occlusion and
    the raw correlation against the JAX disp_init (XLA path)."""
    from s2m2_tpu.models.matching import disp_init
    from s2m2_torch.models.matching import DispInit

    c = 16
    feat = rng.standard_normal((2, 4, 24, c)).astype(np.float32)
    w = rng.standard_normal((c,)).astype(np.float32)
    b = rng.standard_normal((c,)).astype(np.float32)
    want = disp_init({"layer_norm": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}},
                     jnp.asarray(feat), use_positivity=use_positivity)
    mod = DispInit(c)
    mod.load_state_dict({"layer_norm.weight": torch.from_numpy(w),
                         "layer_norm.bias": torch.from_numpy(b)})
    with torch.inference_mode():
        got = mod(torch.from_numpy(np.ascontiguousarray(feat.transpose(0, 3, 1, 2))),
                  use_positivity=use_positivity)
    for g, wt in zip(got[:3], want[:3]):  # (B,1,H,W) vs (B,H,W,1)
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), np.asarray(wt),
                                   atol=1e-4)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=2e-4)
