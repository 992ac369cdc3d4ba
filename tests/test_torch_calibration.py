"""The port's self-calibration (s2m2_torch/calibration) against the JAX
package's: the cases of tests/test_calibration.py; CEM and coordinate
descent identical to s2m2_tpu's for the same seed and analytic objective;
`evaluate_sample` scoring 0.0 only for geometry errors and letting engine
errors through; and on a tiny seeded model, `evaluate_sample` for three
deltas on a raw 64x96 pair within 1e-4 of the JAX engine's."""
import numpy as np
import pytest

import s2m2_torch.calibration.base as base
import s2m2_torch.calibration.cem as cem_mod
import s2m2_torch.calibration.grad_descent as gd_mod
import s2m2_tpu.calibration.base as jax_base
import s2m2_tpu.calibration.cem as jax_cem_mod
import s2m2_tpu.calibration.grad_descent as jax_gd_mod
from s2m2_torch.calibration.cem import cem_calibration
from s2m2_torch.calibration.grad_descent import gradient_descent_calibration
from s2m2_torch.utils.calib import euler_to_rotation_matrix

TARGET = np.array([0.003, -0.002, 0.001])


def _calib_data():
    return {
        "left": {"fx": 800.0, "fy": 800.0, "cx": 320.0, "cy": 240.0,
                 "distortion": np.zeros(5)},
        "right": {"fx": 800.0, "fy": 800.0, "cx": 320.0, "cy": 240.0,
                  "distortion": np.zeros(5)},
        "stereo_extrinsic": {"rotation": np.eye(3),
                             "translation": np.array([-100.0, 0, 0])},
    }


def fake_eval(engine, left, right, calib_data, r, p, y, candidate_log=None):
    """conf = exp(-|delta - target|^2 / (2 s^2)), s = 4 mrad."""
    d = np.array([r, p, y]) - TARGET
    return float(np.exp(-(d @ d) / (2 * 0.004 ** 2)))


@pytest.fixture
def synthetic_objective(monkeypatch):
    """Patch evaluate_sample in both packages with the analytic objective."""
    for mod in (base, cem_mod, gd_mod, jax_base, jax_cem_mod, jax_gd_mod):
        monkeypatch.setattr(mod, "evaluate_sample", fake_eval)
    return TARGET


def _assert_same_result(got, want):
    assert set(got) == set(want)
    for k in ("roll_delta", "pitch_delta", "yaw_delta", "initial_confidence",
              "final_confidence"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["calib_data_new"]["stereo_extrinsic"]["rotation"],
                                  want["calib_data_new"]["stereo_extrinsic"]["rotation"])


def test_cem_converges(synthetic_objective):
    target = synthetic_objective
    res = cem_calibration(None, np.zeros((10, 10, 3)), np.zeros((10, 10, 3)),
                          _calib_data(), seed=0, verbose=False)
    found = np.array([res["roll_delta"], res["pitch_delta"], res["yaw_delta"]])
    assert res["final_confidence"] > res["initial_confidence"]
    assert np.linalg.norm(found - target) < np.linalg.norm(target)
    R_expected = _calib_data()["stereo_extrinsic"]["rotation"] @ \
        euler_to_rotation_matrix(*found)
    np.testing.assert_allclose(
        res["calib_data_new"]["stereo_extrinsic"]["rotation"], R_expected)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_cem_identical_to_jax(synthetic_objective, seed):
    img = np.zeros((10, 10, 3))
    kw = dict(seed=seed, verbose=False, max_iterations=6, num_samples=12)
    got = cem_calibration(None, img, img, _calib_data(), **kw)
    want = jax_cem_mod.cem_calibration(None, img, img, _calib_data(), **kw)
    _assert_same_result(got, want)


def test_gd_improves(synthetic_objective):
    res = gradient_descent_calibration(
        None, np.zeros((10, 10, 3)), np.zeros((10, 10, 3)), _calib_data(),
        verbose=False)
    assert res["final_confidence"] >= res["initial_confidence"]


@pytest.mark.parametrize("step_size", [1e-4, 1e-6])
def test_gd_identical_to_jax(synthetic_objective, step_size):
    img = np.zeros((10, 10, 3))
    kw = dict(verbose=False, step_size=step_size, max_iterations=3)
    got = gradient_descent_calibration(None, img, img, _calib_data(), **kw)
    want = jax_gd_mod.gradient_descent_calibration(None, img, img, _calib_data(), **kw)
    _assert_same_result(got, want)


def test_evaluate_sample_error_returns_zero():
    """A broken calib dict scores 0.0 (reference: base.py:34-36)."""
    img = np.zeros((8, 8, 3), np.uint8)
    assert base.evaluate_sample(None, img, img, {"bad": "calib"}, 0, 0, 0) == 0.0
    data = _calib_data()
    data["left"]["distortion"] = np.zeros(14)  # thin prism + tilt: not supported
    assert base.evaluate_sample(None, img, img, data, 0, 0, 0) == 0.0


class _FailingEngine:
    def confidence_score(self, left, right):
        raise RuntimeError("kernel failed to launch")


class _ConstantEngine:
    def confidence_score(self, left, right):
        assert left.dtype == np.uint8 and left.shape == (48, 64, 3)
        return 0.5


def test_evaluate_sample_engine_errors_propagate():
    """An engine failure is not a bad sample: it raises out of the search."""
    img = np.random.default_rng(0).integers(0, 255, (48, 64, 3), dtype=np.uint8)
    data = _calib_data()
    with pytest.raises(RuntimeError, match="kernel"):
        base.evaluate_sample(_FailingEngine(), img, img, data, 0.001, 0, 0)
    with pytest.raises(RuntimeError, match="kernel"):
        cem_calibration(_FailingEngine(), img, img, data, seed=0, verbose=False)
    log = []
    eng = _ConstantEngine()
    assert base.evaluate_sample(eng, img, img, data, 0.001, 0, 0, candidate_log=log) == 0.5
    assert base.evaluate_sample(eng, img, img, {}, 0, 0, 0, candidate_log=log) == 0.0
    assert [r["score"] for r in log] == [0.5, 0.0]
    assert log[0]["maps_ms"] > 0 and log[0]["remap_ms"] > 0 and log[0]["score_ms"] >= 0
    assert "KeyError" in log[1]["error"]


def test_keypoint_estimate_rotation_synthetic():
    from s2m2_torch.calibration.keypoint import estimate_rotation

    rng = np.random.default_rng(0)
    K = np.array([[800.0, 0, 320.0], [0, 800.0, 240.0], [0, 0, 1.0]])
    R_true = euler_to_rotation_matrix(0.02, -0.01, 0.015)
    t = np.array([-1.0, 0.02, 0.01])
    pts3d = np.c_[rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200),
                  rng.uniform(4, 12, 200)]

    def project(P, R, t):
        cam = P @ R.T + t
        uv = cam[:, :2] / cam[:, 2:3]
        return (uv * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]).astype(np.float32)

    pts1 = project(pts3d, np.eye(3), np.zeros(3))
    pts2 = project(pts3d, R_true, t)
    R_est, err = estimate_rotation(pts1, pts2, K)
    assert err is None
    np.testing.assert_allclose(R_est, R_true, atol=1e-3)


def test_keypoint_calibration_equals_jax():
    """The uniform result schema on every exit path, and the same result as
    the JAX package's keypoint calibrator on the same pair."""
    import cv2

    from s2m2_torch.calibration.keypoint import keypoint_based_calibration
    from s2m2_tpu.calibration.keypoint import \
        keypoint_based_calibration as jax_keypoint_based_calibration

    calib = _calib_data()
    blank = np.zeros((64, 64), np.uint8)
    res = keypoint_based_calibration(blank, blank, calib, verbose=False)
    assert res["success"] is False and res["roll_delta"] == 0.0
    np.testing.assert_array_equal(
        res["calib_data_new"]["stereo_extrinsic"]["rotation"],
        calib["stereo_extrinsic"]["rotation"])

    rng = np.random.default_rng(1)
    tex = cv2.GaussianBlur(rng.integers(0, 255, (240, 320), dtype=np.uint8), (0, 0), 1.5)
    right = np.roll(tex, -7, axis=1)
    res2 = keypoint_based_calibration(tex, right, calib, verbose=False)
    want = jax_keypoint_based_calibration(tex, right, calib, verbose=False)
    assert set(res2) == set(res) == set(want)
    for k in ("success", "reason", "num_matches", "roll_delta", "pitch_delta", "yaw_delta"):
        assert res2[k] == want[k], k


def _raw_pair_and_calib(h=64, w=96):
    """A textured raw pair (the right view shifted 3 px) and a sensor
    calibration at (w, h) with distortion and a small stereo rotation."""
    g = np.random.default_rng(11)
    base_img = g.uniform(0, 255, (h // 4 + 1, w // 4 + 1, 3))
    left = np.repeat(np.repeat(base_img, 4, 0), 4, 1)[:h, :w]
    left = np.clip(left + g.normal(0, 6, left.shape), 0, 255).astype(np.uint8)
    right = np.roll(left, -3, axis=1)
    s = w / 1216
    calib = {
        "left": {"fx": 1000.0 * s, "fy": 1000.0 * s, "cx": w / 2 + 0.4, "cy": h / 2 - 0.3,
                 "distortion": np.array([-0.05, 0.01, 0.0005, -0.0003, 0.0])},
        "right": {"fx": 1003.0 * s, "fy": 1003.0 * s, "cx": w / 2 - 0.5, "cy": h / 2 + 0.2,
                  "distortion": np.array([-0.045, 0.009, 0.0, 0.0004, 0.0])},
        "stereo_extrinsic": {"rotation": euler_to_rotation_matrix(0.002, -0.001, 0.003),
                             "translation": np.array([-120.0, 0.0, 0.0])},
    }
    return left, right, calib


def test_evaluate_sample_matches_jax_engine():
    """Both packages' evaluate_sample on a tiny seeded fp32 model (16
    channels, one transformer, one refinement) on the CPU: the port's numpy
    maps and native remap against cv2's maps and the JAX native remap, the
    port's engine against the JAX engine."""
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.runtime.engine import StereoEngine
    from s2m2_tpu.config import ModelConfig as JaxModelConfig
    from s2m2_tpu.runtime.engine import StereoEngine as JaxStereoEngine

    kw = dict(feature_channels=16, num_transformer=1, refine_iter=1)
    eng = StereoEngine(ModelConfig(**kw), precision="fp32", seed=0, device="cpu")
    jeng = JaxStereoEngine(JaxModelConfig(**kw), precision="fp32", seed=0)
    left, right, calib = _raw_pair_and_calib()
    for delta in ((0.0, 0.0, 0.0), (0.004, -0.003, 0.002), (-0.01, 0.006, 0.008)):
        got = base.evaluate_sample(eng, left, right, calib, *delta)
        want = jax_base.evaluate_sample(jeng, left, right, calib, *delta)
        assert 0.0 < want < 1.0
        assert abs(got - want) <= 1e-4, (delta, got, want)


def test_render_calibration_comparison():
    """Headless before/after panel: runs the engine twice, composes epipolar
    overlays and disparity/confidence rows into one uint8 image."""
    from s2m2_torch.calibration.visualize import render_calibration_comparison
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.runtime.engine import StereoEngine

    rng = np.random.default_rng(3)
    eng = StereoEngine(ModelConfig(feature_channels=16, num_transformer=1, refine_iter=1),
                       precision="fp32", device="cpu")
    imgs = [rng.uniform(0, 255, (40, 64, 3)).astype(np.float32) for _ in range(4)]
    panel, sb, sa = render_calibration_comparison(eng, *imgs, num_lines=4)
    assert panel.dtype == np.uint8 and panel.ndim == 3
    assert panel.shape == (4 * 40, 2 * 64, 3)  # side-by-side rows
    assert np.isfinite(sb) and np.isfinite(sa)
    assert sb == eng.run(imgs[0], imgs[1])[3]
