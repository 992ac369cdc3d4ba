"""The port's int8 engine (`StereoEngine(precision="int8" | "int8a" |
"int8r")`) on the CPU, against the JAX package's int8 path on the golden
fixtures: the same sites, the same scales, the same disparity with shared
scales, and drift from the fp32 reference within the JAX package's own
bounds (tests/test_quant.py, tests/test_trained_drift.py)."""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from s2m2_torch.config import ModelConfig
from s2m2_torch.models import quant
from s2m2_torch.models.s2m2 import S2M2
from s2m2_torch.runtime.engine import StereoEngine, cast_params, fp32_keep_paths
from s2m2_torch.tools.convert import load_npz

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FIXTURES = ["s2m2_c32_ntr1.npz", "s2m2_c32_ntr1_neg_up.npz"]
POLICY = {"int8": {}, "int8a": {"aligned": True}, "int8r": {"residency": True}}


def _fixture(name):
    """(port cfg, NHWC img0, img1, fp32 reference disparity)."""
    with np.load(os.path.join(GOLDEN, name)) as z:
        meta = list(z["__meta"])
        img0, img1, ref = (np.transpose(z[k], (0, 2, 3, 1))
                           for k in ("__img0", "__img1", "__disp"))
    cfg = ModelConfig(feature_channels=int(meta[0]), num_transformer=int(meta[1]),
                      refine_iter=int(meta[2]),
                      use_positivity=bool(meta[3]) if len(meta) > 3 else True,
                      output_upsample=bool(meta[4]) if len(meta) > 4 else False)
    return cfg, img0, img1, ref


def _port_model(name, bf16):
    cfg, img0, img1, _ = _fixture(name)
    model = S2M2(cfg)
    model.load_state_dict(load_npz(os.path.join(GOLDEN, name)))
    dtype = torch.bfloat16 if bf16 else torch.float32
    if bf16:
        cast_params(model, dtype, fp32_keep_paths(cfg))
    return model.eval(), torch.from_numpy(img0).to(dtype), torch.from_numpy(img1).to(dtype)


def _jax_model(name, bf16):
    """(JAX cfg, params, img0, img1), cast as the JAX engine casts."""
    from s2m2_tpu.config import ModelConfig as JaxConfig
    from s2m2_tpu.runtime.engine import cast_params as jax_cast
    from s2m2_tpu.runtime.engine import fp32_keep_paths as jax_keep
    from s2m2_tpu.tools.convert_checkpoint import nest
    cfg, img0, img1, _ = _fixture(name)
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in (
        "feature_channels", "num_transformer", "refine_iter", "use_positivity",
        "output_upsample")})
    with np.load(os.path.join(GOLDEN, name)) as z:
        params = nest({k: jnp.asarray(z[k]) for k in z.files if not k.startswith("__")})
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    if bf16:
        params = jax_cast(params, dtype, jax_keep(jcfg))
    return jcfg, params, jnp.asarray(img0, dtype), jnp.asarray(img1, dtype)


def _port_observe(model, a, b, **policy):
    with torch.inference_mode(), quant.observe(**policy) as obs:
        model(a, b)
    return torch.stack(obs).float().numpy()


@pytest.mark.parametrize("fixture,precision", [
    (FIXTURES[0], "int8"), (FIXTURES[0], "int8a"), (FIXTURES[0], "int8r"),
    (FIXTURES[1], "int8")])
def test_site_count_matches_jax(fixture, precision):
    """Under the engine's cast policy and skip_fp32, the port's observe pass
    records as many sites as the JAX one traces (the stem and mask heads
    judged on the JAX package's packed forms, per-head proj sites, int8r's
    residual sites)."""
    from s2m2_tpu.models import quant as jquant
    from s2m2_tpu.models.s2m2 import forward
    jcfg, params, ja, jb = _jax_model(fixture, bf16=True)
    policy = POLICY[precision]

    def observer(p, a, b):
        with jquant.observe(skip_fp32=True, **policy) as obs:
            forward(p, a, b, jcfg)
        return jnp.stack(obs)

    want = jax.eval_shape(observer, params, ja, jb).shape[0]
    model, a, b = _port_model(fixture, bf16=True)
    got = _port_observe(model, a, b, skip_fp32=True, **policy)
    assert len(got) == want > 0


@pytest.fixture(scope="module")
def jax_fp32_int8():
    """The JAX package's int8 path on fixture 1 in float32: its observed
    amax, and its disparity quantized with those scales."""
    from s2m2_tpu.models import quant as jquant
    from s2m2_tpu.models.s2m2 import forward
    jcfg, params, ja, jb = _jax_model(FIXTURES[0], bf16=False)

    def observer(p, a, b):
        with jquant.observe() as obs:
            forward(p, a, b, jcfg)
        return jnp.stack(obs)

    # XLA's optimizations off: a third of the compile time on the CPU, and
    # the int8 sums are exact either way
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        amax = np.asarray(jax.jit(observer)(params, ja, jb), np.float32)
        scales = tuple(float(v) / 127.0 for v in amax)
        with jquant.quantized(scales):
            disp = jax.jit(lambda p, a, b: forward(p, a, b, jcfg)[0])(params, ja, jb)
        disp = np.asarray(disp, np.float32)
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)
    return amax, scales, disp


def test_scales_match_jax(jax_fp32_int8):
    """Float32 weights and images (so bf16 rounding of the float path, which
    moves amax by a few bf16 ulps, is out of the comparison): every site's
    amax within 1% of the JAX package's."""
    amax, _, _ = jax_fp32_int8
    model, a, b = _port_model(FIXTURES[0], bf16=False)
    got = _port_observe(model, a, b)
    assert len(got) == len(amax)
    np.testing.assert_allclose(got, amax, rtol=1e-2)


def test_int8_disparity_matches_jax_with_its_scales(jax_fp32_int8, tmp_path):
    """The JAX scales loaded into the port: mean |disp - disp_jax| < 0.01 px."""
    _, scales, want = jax_fp32_int8
    model, a, b = _port_model(FIXTURES[0], bf16=False)
    with torch.inference_mode(), quant.quantized(scales):
        got = model(a, b)[0].numpy()
    delta = np.abs(got - want).mean()
    assert delta < 0.01, f"port vs JAX int8 disparity {delta}"
    # the same scales as the JAX engine's .npy file load into a bf16 engine
    path = str(tmp_path / "jax_scales.npy")
    np.save(path, np.asarray(scales, np.float32))
    cfg, img0, img1, ref = _fixture(FIXTURES[0])
    eng = StereoEngine(cfg, checkpoint=os.path.join(GOLDEN, FIXTURES[0]),
                       precision="int8", device="cpu")
    eng.load_calibration(path)
    disp = eng.forward_padded(img0, img1)[0].numpy()
    assert np.abs(disp - ref).mean() < 0.01


# The JAX package's bounds (tests/test_quant.py:186-191), EPE against the
# fp32 reference of each fixture.
@pytest.mark.parametrize("fixture,precision,bound", [
    ("s2m2_c32_ntr1.npz", "int8", 0.01),
    ("s2m2_c32_ntr1_neg_up.npz", "int8", 0.08),
    ("s2m2_c32_ntr1.npz", "int8r", 0.015),
    ("s2m2_c32_ntr1_neg_up.npz", "int8r", 0.09),
])
def test_int8_drift_on_golden(fixture, precision, bound):
    cfg, img0, img1, ref = _fixture(fixture)
    eng = StereoEngine(cfg, checkpoint=os.path.join(GOLDEN, fixture),
                       precision=precision, device="cpu")
    disp = eng.forward_padded(img0, img1)[0].numpy()  # calibrates on the pair
    assert eng.quant_scales is not None and eng.quant_gemms > 0
    epe = np.abs(disp - ref).mean()
    assert epe < bound, f"{precision} EPE vs reference fp32 {epe} (bound {bound})"


@pytest.fixture(scope="module")
def trained():
    """The trained c32 fixture: a held-out synthetic scene and the port's
    fp32 disparity on it (tests/test_trained_drift.py)."""
    from s2m2_torch.train.data import synthetic_stereo_batches
    cfg = ModelConfig(feature_channels=32, num_transformer=1, refine_iter=2)
    scene = next(synthetic_stereo_batches(batch=1, height=96, width=128, max_disp=16,
                                          seed=9999))
    ckpt = os.path.join(GOLDEN, "trained_c32.npz")
    ref = StereoEngine(cfg, checkpoint=ckpt, precision="fp32", device="cpu").forward_padded(
        scene["img0"], scene["img1"])[0].numpy()
    return cfg, ckpt, scene, ref


def test_trained_model_actually_learned(trained):
    """The port's fp32 disparity on the trained checkpoint is the JAX
    engine's, and its held-out EPE is far below the init's 2.37 px."""
    from s2m2_tpu.config import ModelConfig as JaxConfig
    from s2m2_tpu.runtime.engine import StereoEngine as JaxEngine
    cfg, ckpt, scene, ref = trained
    jax_eng = JaxEngine(JaxConfig(feature_channels=32, num_transformer=1, refine_iter=2),
                        checkpoint=ckpt, precision="fp32")
    want = np.asarray(jax_eng.forward_padded(scene["img0"], scene["img1"])[0])
    np.testing.assert_allclose(ref, want, rtol=0, atol=1e-4)
    epe = float(np.abs(ref - scene["gt_disp"])[scene["valid"] > 0].mean())
    assert epe < 1.3, f"trained fixture held-out EPE {epe}"


@pytest.mark.parametrize("precision,bound", [("int8", 0.03), ("int8r", 0.04),
                                             ("bf16", 0.04)])
def test_trained_int8_drift(trained, precision, bound):
    """Drift from the port's fp32 disparity within the JAX file's bounds
    (int8 calibrated on the scene itself; bf16 for comparison)."""
    cfg, ckpt, scene, ref = trained
    eng = StereoEngine(cfg, checkpoint=ckpt, precision=precision, device="cpu")
    disp = eng.forward_padded(scene["img0"], scene["img1"])[0].numpy()
    epe = float(np.abs(disp - ref).mean())
    assert epe < bound, f"trained {precision} drift {epe}"


def test_trained_percentile_calibration(trained):
    cfg, ckpt, scene, ref = trained
    eng = StereoEngine(cfg, checkpoint=ckpt, precision="int8", device="cpu")
    eng.calibrate(scene["img0"], scene["img1"], percentile=99.9)
    disp = eng.forward_padded(scene["img0"], scene["img1"])[0].numpy()
    epe = float(np.abs(disp - ref).mean())
    assert epe < 0.05, f"trained percentile-calibrated int8 drift {epe}"


def test_trained_low_res_calibration(trained):
    """Scales from the scene at half resolution serve the full one."""
    from s2m2_torch.utils.image import image_pad
    cfg, ckpt, scene, ref = trained
    eng = StereoEngine(cfg, checkpoint=ckpt, precision="int8", device="cpu")
    eng.calibrate(image_pad(scene["img0"][:, ::2, ::2]), image_pad(scene["img1"][:, ::2, ::2]))
    disp = eng.forward_padded(scene["img0"], scene["img1"])[0].numpy()
    epe = float(np.abs(disp - ref).mean())
    assert epe < 0.08, f"trained low-res-calibrated int8 drift {epe}"


def test_engine_calibration_api(tmp_path, rng):
    cfg, img0, img1, _ = _fixture(FIXTURES[0])
    ckpt = os.path.join(GOLDEN, FIXTURES[0])
    eng = StereoEngine(cfg, checkpoint=ckpt, precision="int8", device="cpu")
    a, b = torch.from_numpy(img0).bfloat16(), torch.from_numpy(img1).bfloat16()
    with pytest.raises(RuntimeError, match="not calibrated"):
        eng._forward(a, b)  # no scales: raises, never a bf16 forward
    s1 = eng.calibrate(img0, img1).copy()
    assert len(s1) == len(eng.quant_scales) > 50 and (s1 > 0).all()
    np.testing.assert_array_equal(eng.calibrate(img0, img1), s1)  # a fixed point
    other = rng.uniform(0, 255, img0.shape).astype(np.float32)
    assert (eng.calibrate(other, other) >= s1).all()  # amax accumulates by max
    d1 = eng.forward_padded(img0, img1)[0]

    path = str(tmp_path / "scales.npy")
    eng.save_calibration(path)
    fresh = StereoEngine(cfg, checkpoint=ckpt, precision="int8", device="cpu")
    with pytest.raises(RuntimeError, match="nothing to save"):
        fresh.save_calibration(path)
    fresh.load_calibration(path)
    np.testing.assert_array_equal(fresh.forward_padded(img0, img1)[0], d1)

    np.save(path, eng.quant_scales[:-1])  # one site short
    fresh.load_calibration(path)
    with pytest.raises(ValueError, match="diverged"):
        fresh.forward_padded(img0, img1)

    # percentile calibration: below the max at every site
    pct = StereoEngine(cfg, checkpoint=ckpt, precision="int8", device="cpu")
    sp = pct.calibrate(img0, img1, percentile=99.0)
    amax = StereoEngine(cfg, checkpoint=ckpt, precision="int8",
                        device="cpu").calibrate(img0, img1)
    assert (sp <= amax).all() and (sp < amax).mean() > 0.5 and (sp > 0).all()
    with pytest.raises(RuntimeError, match="no int8 sites"):
        StereoEngine(cfg, checkpoint=ckpt, precision="bf16", device="cpu").calibrate(
            img0, img1)


def test_percentile_matches_numpy_linear(rng):
    v = torch.from_numpy(np.abs(rng.standard_normal(10007)).astype(np.float32))
    for p in (50.0, 99.0, 99.9):
        want = np.percentile(v.numpy().astype(np.float64), p)
        assert float(quant._percentile(v, p)) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("precision", ["int8a", "int8r"])
def test_int8a_int8r_engines_serve(precision):
    """The two other int8 engines calibrate on their first request and serve
    finite maps (int8a on this c32 model keeps only the shared sites and
    int8r adds the residual stream's)."""
    cfg, img0, img1, ref = _fixture(FIXTURES[0])
    eng = StereoEngine(cfg, checkpoint=os.path.join(GOLDEN, FIXTURES[0]),
                       precision=precision, device="cpu")
    disp, occ, conf, score, ms = eng.run(img0[0], img1[0])
    assert np.isfinite(disp).all() and disp.shape == ref.shape[1:3]
    assert eng.quant_scales is not None
