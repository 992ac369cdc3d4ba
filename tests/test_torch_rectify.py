"""The port's numpy rectification (s2m2_torch/utils/calib.py) against OpenCV:
stereoRectify (zero disparity, alpha 0), initUndistortRectifyMap (float32
maps), undistortPoints and Rodrigues, as the JAX package computes them with
cv2 (s2m2_tpu/utils/calib.py). Matrices to 1e-6 of their largest entry,
maps to 1e-3 px; the float32 remap of `rectify_images` within 1e-3 of
cv2.remap."""
import cv2
import numpy as np
import pytest

from s2m2_torch.utils import calib as C
from s2m2_torch.utils.image import rectify_images
from s2m2_tpu.utils import calib as J
from s2m2_tpu.utils.image import rectify_images as jax_rectify_images

DIST = {
    "zero": np.zeros(5),
    "k4": np.array([-0.04, 0.012, 0.0008, -0.0006]),
    "k5": np.array([-0.05, 0.01, 0.001, -0.0005, 0.002]),
    "k8": np.array([-0.05, 0.01, 0.001, -0.0005, 0.002, 0.01, -0.003, 0.001]),
}
SIZES = [(64, 48), (640, 480), (1216, 1024)]
DELTAS = [(0.0, 0.0, 0.0), (0.003, -0.002, 0.004), (0.01, 0.01, -0.01)]  # up to 10 mrad


def calib_data(w, h, dist):
    """A sensor calibration scaled to (w, h): fx ~ 1000 at 1216 px, principal
    points off centre and unequal, a 120 mm baseline and a small rotation."""
    s = w / 1216
    return {
        "left": {"fx": 1000.0 * s, "fy": 1001.0 * s, "cx": w / 2 + 3.1 * s,
                 "cy": h / 2 - 2.2 * s, "distortion": dist},
        "right": {"fx": 1002.0 * s, "fy": 1000.5 * s, "cx": w / 2 - 4.3 * s,
                  "cy": h / 2 + 1.7 * s, "distortion": dist * 0.9},
        "stereo_extrinsic": {"rotation": C.euler_to_rotation_matrix(0.002, -0.003, 0.001),
                             "translation": np.array([-120.0, 0.4, -0.8])},
    }


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dist", list(DIST))
def test_rectification_matches_cv2(dist, size):
    data = calib_data(*size, DIST[dist])
    for delta in DELTAS:
        dR = C.create_delta_rotation(*delta)
        got = C.compute_stereo_rectification(data, size, dR)
        want = J.compute_stereo_rectification(data, size, dR)
        for k in ("R1", "R2", "P1", "P2", "Q"):
            assert got[k].shape == want[k].shape
            assert rel_err(got[k], want[k]) <= 1e-6, (k, delta)
        for k in ("leftMapX", "leftMapY", "rightMapX", "rightMapY"):
            assert got[k].dtype == np.float32 and got[k].shape == (size[1], size[0])
            assert float(np.abs(got[k] - want[k]).max()) <= 1e-3, (k, delta)
        for k in ("K1", "K2", "R", "T"):
            np.testing.assert_array_equal(got[k], want[k])


def test_vertical_stereo_matches_cv2():
    """A baseline along y takes the other branch (idx = 1) of stereoRectify."""
    data = calib_data(320, 240, DIST["k5"])
    data["stereo_extrinsic"]["translation"] = np.array([0.5, -90.0, 1.0])
    got = C.compute_stereo_rectification(data, (320, 240))
    want = J.compute_stereo_rectification(data, (320, 240))
    for k in ("R1", "R2", "P1", "P2", "Q"):
        assert rel_err(got[k], want[k]) <= 1e-6, k
    for k in ("leftMapX", "leftMapY", "rightMapX", "rightMapY"):
        assert float(np.abs(got[k] - want[k]).max()) <= 1e-3, k


@pytest.mark.parametrize("n", [0, 3, 6, 12, 14])
def test_unsupported_distortion_lengths_raise(n):
    data = calib_data(64, 48, np.zeros(n))
    with pytest.raises(ValueError, match="4, 5 or 8"):
        C.compute_stereo_rectification(data, (64, 48))


def test_zero_baseline_raises():
    data = calib_data(64, 48, DIST["zero"])
    data["stereo_extrinsic"]["translation"] = np.zeros(3)
    with pytest.raises(ValueError, match="translation"):
        C.compute_stereo_rectification(data, (64, 48))


@pytest.mark.parametrize("dist", ["k5", "k8"])
def test_undistort_points_matches_cv2(dist):
    rng = np.random.default_rng(0)
    K = C.build_camera_matrix(800.0, 805.0, 330.0, 235.0)
    R = C.euler_to_rotation_matrix(0.01, -0.02, 0.005)
    P = np.array([[790.0, 0, 320.0, 0], [0, 790.0, 240.0, 0], [0, 0, 1, 0]])
    pts = rng.uniform(0, 640, (200, 2))
    for r, p in ((None, None), (R, P)):
        want = cv2.undistortPoints(pts.reshape(-1, 1, 2), K, DIST[dist], R=r, P=p).reshape(-1, 2)
        got = C.undistort_points(pts, K, DIST[dist], r, p)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_rodrigues_matches_cv2():
    rng = np.random.default_rng(1)
    vecs = [rng.normal(0, 0.5, 3), np.array([1e-7, 0, 0]), np.array([0.0, 0.0, 0.0]),
            np.array([np.pi - 1e-9, 0, 0]), np.array([0, 2.0, 0.3])]
    for v in vecs:
        np.testing.assert_allclose(C.rodrigues_to_matrix(v), cv2.Rodrigues(v)[0], atol=1e-15)
        R = cv2.Rodrigues(v)[0]
        np.testing.assert_allclose(C.rodrigues_to_vector(R), cv2.Rodrigues(R)[0].ravel(),
                                   atol=1e-12)


def test_rectify_images_matches_cv2_remap():
    """float32 pairs: the numpy remap within 1e-3 of cv2.remap (the JAX
    package's path for non-uint8 images); uint8 pairs: the native remap
    within 1 grey level of the JAX package's."""
    rng = np.random.default_rng(2)
    w, h = 160, 120
    data = calib_data(w, h, DIST["k5"])
    rect = C.compute_stereo_rectification(data, (w, h), C.create_delta_rotation(0.004, 0, -0.003))
    left = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    right = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    got = rectify_images(left, right, rect)
    want = jax_rectify_images(left, right, rect)
    for g, r in zip(got, want):
        assert g.dtype == np.float32 and g.shape == r.shape
        assert float(np.abs(g - r).max()) <= 1e-3
    l8, r8 = left.astype(np.uint8), right.astype(np.uint8)
    for g, r in zip(rectify_images(l8, r8, rect), jax_rectify_images(l8, r8, rect)):
        assert g.dtype == np.uint8
        assert int(np.abs(g.astype(int) - r.astype(int)).max()) <= 1
