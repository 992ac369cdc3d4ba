"""Model-free keypoint-based calibration.

Behavioral parity with the reference keypoint calibrator (reference:
src/s2m2/calibration/keypoint_matching.py — SIFT + BF-KNN with Lowe ratio
0.75, >=10 matches, essential-matrix RANSAC + recoverPose, delta Euler vs
the stored rotation), restructured into two testable stages and with one
uniform return contract (the reference returns a bare rotation matrix on
failure but a dict on success; here every path returns the same dict).
Never calls the stereo model. A copy of s2m2_tpu/calibration/keypoint.py:
SIFT and the pose estimate are OpenCV, imported when they are called, so this
runs only where cv2 is installed.
"""
from __future__ import annotations

import copy

import numpy as np

from ..utils.calib import rotation_matrix_to_euler

LOWE_RATIO = 0.75
MIN_MATCHES = 10
RANSAC_PROB = 0.999
RANSAC_THRESHOLD = 1.0


def detect_and_match(left, right):
    """SIFT correspondences between a stereo pair.

    Returns (pts1, pts2) float32 arrays of matched pixel coordinates, or
    (None, reason) when detection/matching fails.
    """
    import cv2

    def gray(img):
        return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 else img

    sift = cv2.SIFT_create()
    kp1, des1 = sift.detectAndCompute(gray(left), None)
    kp2, des2 = sift.detectAndCompute(gray(right), None)
    if des1 is None or des2 is None:
        return None, "no keypoints detected in one or both images"

    matcher = cv2.BFMatcher(cv2.NORM_L2, crossCheck=False)
    pairs = matcher.knnMatch(des1, des2, k=2)
    good = [m for m, n in pairs if m.distance < LOWE_RATIO * n.distance]
    if len(good) < MIN_MATCHES:
        return None, f"only {len(good)} good matches (need {MIN_MATCHES})"
    pts1 = np.float32([kp1[m.queryIdx].pt for m in good])
    pts2 = np.float32([kp2[m.trainIdx].pt for m in good])
    return (pts1, pts2), f"{len(good)} good matches"


def estimate_rotation(pts1, pts2, K):
    """Relative rotation from matched points via essential-matrix RANSAC.

    Returns (R, None) or (None, reason).
    """
    import cv2

    E, _ = cv2.findEssentialMat(pts1, pts2, K, method=cv2.RANSAC,
                                prob=RANSAC_PROB, threshold=RANSAC_THRESHOLD)
    if E is None:
        return None, "essential-matrix estimation failed"
    _, R, _, _ = cv2.recoverPose(E, pts1, pts2, K)
    return R, None


def _result(calib_data, *, success, reason, rotation=None, num_matches=0):
    """Uniform result schema for every exit path."""
    if rotation is None:
        deltas = dict(roll_delta=0.0, pitch_delta=0.0, yaw_delta=0.0)
        calib_new = copy.deepcopy(calib_data)
    else:
        original = calib_data["stereo_extrinsic"]["rotation"]
        r, p, y = rotation_matrix_to_euler(rotation @ original.T)
        deltas = dict(roll_delta=r, pitch_delta=p, yaw_delta=y)
        calib_new = copy.deepcopy(calib_data)
        calib_new["stereo_extrinsic"]["rotation"] = rotation
    return dict(success=success, reason=reason, num_matches=num_matches,
                calib_data_new=calib_new, **deltas)


def keypoint_based_calibration(left, right, calib_data, *, verbose=True):
    """Estimate extrinsic rotation deltas from SIFT correspondences.

    Always returns the same dict schema:
      {success, reason, num_matches, roll_delta, pitch_delta, yaw_delta,
       calib_data_new}
    On failure the deltas are zero and calib_data_new equals the input.
    """
    log = print if verbose else (lambda *a, **k: None)

    matched, info = detect_and_match(left, right)
    log(info)
    if matched is None:
        return _result(calib_data, success=False, reason=info)
    pts1, pts2 = matched

    lc = calib_data["left"]
    K = np.array([[lc["fx"], 0, lc["cx"]],
                  [0, lc["fy"], lc["cy"]],
                  [0, 0, 1]])
    R, err = estimate_rotation(pts1, pts2, K)
    if R is None:
        log(err)
        return _result(calib_data, success=False, reason=err,
                       num_matches=len(pts1))

    res = _result(calib_data, success=True, reason="ok", rotation=R,
                  num_matches=len(pts1))
    log(f"Deltas - roll {res['roll_delta']:.4f} "
        f"pitch {res['pitch_delta']:.4f} yaw {res['yaw_delta']:.4f}")
    return res
