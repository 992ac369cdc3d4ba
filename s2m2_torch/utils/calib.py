"""Calibration math and parsers (host-side numpy/scipy), without OpenCV.

A copy of s2m2_tpu/utils/calib.py (reference: src/s2m2/core/utils/
calib_utils.py and xml_calibration_reader.py), except that the stereo
rectification is written here in numpy instead of calling cv2:

  * XML sensor calibration schema: distorted_{left,right,rgb}_intrinsic
    (fx/fy/cx/cy/dist), stereo_extrinsic R|T, left2rgb R|T.
  * rotation conversions (Euler xyz <-> matrix, axis-angle, small-angle).
  * `stereo_rectify`: cv2.stereoRectify(flags=CALIB_ZERO_DISPARITY,
    alpha=0); `init_undistort_rectify_map`: cv2.initUndistortRectifyMap(...,
    CV_32FC1); `undistort_points`: cv2.undistortPoints at its default of 5
    fixed iterations. Each follows OpenCV's algorithm step by step, including
    where it rounds points to float32, and is held against cv2 by
    tests/test_torch_rectify.py. Distortion vectors hold 4, 5 or 8
    coefficients (k1 k2 p1 p2 [k3 [k4 k5 k6]]); 12 and 14 (thin prism, tilt)
    raise.

Plus the dataset calib parsers used by the demos:
  * Middlebury calib.txt (cam0/cam1/doffs/baseline)
    (reference: demo/visualize_3d_middlebury.py:54-69)
  * OpenCV FileStorage calib.xml (Booster), the one function here that
    imports cv2 (reference: demo/visualize_3d_booster.py:54-61)
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np


# --- rotation helpers -------------------------------------------------------

def euler_to_rotation_matrix(roll, pitch, yaw):
    from scipy.spatial.transform import Rotation as R
    return R.from_euler("xyz", [roll, pitch, yaw]).as_matrix()


def rotation_matrix_to_euler(rot):
    from scipy.spatial.transform import Rotation as R
    return R.from_matrix(rot).as_euler("xyz")


def axis_angle_to_rotation_matrix(axis, angle):
    from scipy.spatial.transform import Rotation as R
    return R.from_rotvec(np.asarray(axis) * angle).as_matrix()


def create_delta_rotation(roll_delta=0.0, pitch_delta=0.0, yaw_delta=0.0):
    return euler_to_rotation_matrix(roll_delta, pitch_delta, yaw_delta)


def apply_delta_rotation(original_R, delta_R):
    return original_R @ delta_R


def small_angle_rotation_to_matrix(delta_angles):
    r, p, y = delta_angles
    return np.array([[1.0, -y, p], [y, 1.0, -r], [-p, r, 1.0]])


def validate_rotation_matrix(R):
    if np.shape(R) != (3, 3):
        return False
    return (np.allclose(R @ np.transpose(R), np.eye(3), atol=1e-6)
            and np.isclose(np.linalg.det(R), 1.0, atol=1e-6))


# --- XML sensor calibration -------------------------------------------------

def _floats(text):
    return np.array([float(x.strip()) for x in text.split(",")])


def parse_xml_calibration(calib_xml_path):
    tree = ET.parse(calib_xml_path)
    root = tree.getroot()
    out = {}
    for name in ("left", "right", "rgb"):
        node = root.find(f"distorted_{name}_intrinsic")
        out[name] = {
            "fx": float(node.find("fx").text),
            "fy": float(node.find("fy").text),
            "cx": float(node.find("cx").text),
            "cy": float(node.find("cy").text),
            "distortion": _floats(node.find("dist").text),
        }
    for name in ("stereo_extrinsic", "left2rgb"):
        node = root.find(name)
        out[name] = {
            "rotation": _floats(node.find("rotation").text).reshape(3, 3),
            "translation": _floats(node.find("translation").text),
        }
    return out


def load_calibration_data(calib_xml_path):
    if not os.path.exists(calib_xml_path):
        print(f"XML calibration file not found: {calib_xml_path}")
        return None
    try:
        return parse_xml_calibration(calib_xml_path)
    except Exception as e:  # tolerant loader, reference: calib_utils.py:20-22
        print(f"Error loading calibration data: {e}")
        return None


def build_camera_matrix(fx, fy, cx, cy):
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


# --- OpenCV's rectification, in numpy ----------------------------------------

def distortion_coefficients(dist):
    """(k1, k2, p1, p2, k3, k4, k5, k6) float64 from a 4-, 5- or 8-vector."""
    d = np.asarray(dist, np.float64).ravel()
    if d.size not in (4, 5, 8):
        raise ValueError(f"distortion needs 4, 5 or 8 coefficients (k1 k2 p1 p2 "
                         f"[k3 [k4 k5 k6]]), got {d.size}")
    return np.concatenate([d, np.zeros(8 - d.size)])


def rodrigues_to_vector(R):
    """cv2.Rodrigues of a 3x3 matrix: the rotation vector of its nearest
    rotation (U V^T of its SVD); below 1e-5 of |sin| a rotation by less than
    90 degrees is the zero vector."""
    u, _, vt = np.linalg.svd(np.asarray(R, np.float64))
    R = u @ vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.sqrt((r @ r) * 0.25)
    c = min(max((R[0, 0] + R[1, 1] + R[2, 2] - 1) * 0.5, -1.0), 1.0)
    theta = np.arccos(c)
    if s >= 1e-5:
        return r * (theta / (2 * s))
    if c > 0:
        return np.zeros(3)
    r = np.sqrt(np.maximum((np.diag(R) + 1) * 0.5, 0.0))
    r[1] *= -1.0 if R[0, 1] < 0 else 1.0
    r[2] *= -1.0 if R[0, 2] < 0 else 1.0
    if abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2]) and (R[1, 2] > 0) != (r[1] * r[2] > 0):
        r[2] = -r[2]
    return r * (theta / np.linalg.norm(r))


def rodrigues_to_matrix(r):
    """cv2.Rodrigues of a rotation vector: the 3x3 matrix."""
    r = np.asarray(r, np.float64).ravel()
    theta = np.sqrt(r @ r)
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    r = r / theta
    r_x = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])
    return c * np.eye(3) + (1 - c) * np.outer(r, r) + s * r_x


def undistort_points(pts, K, dist, R=None, P=None, iterations=5):
    """cv2.undistortPoints: (N, 2) pixel points through the inverse of the
    distortion model by `iterations` fixed-point steps (OpenCV's default
    criterion is 5 steps), then R, then the first 3 columns of P (normalized
    coordinates without P). Returns (N, 2) float64; OpenCV stores float32
    where its input points were float32, which the caller rounds."""
    k1, k2, p1, p2, k3, k4, k5, k6 = distortion_coefficients(dist)
    K = np.asarray(K, np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    RR = np.eye(3) if R is None else np.asarray(R, np.float64)
    if P is not None:
        RR = np.asarray(P, np.float64)[:, :3] @ RR
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    x0 = x = (pts[:, 0] - cx) * (1.0 / fx)
    y0 = y = (pts[:, 1] - cy) * (1.0 / fy)
    live = np.ones(len(pts), bool)  # OpenCV stops a point whose icdist < 0
    for _ in range(iterations):
        r2 = x * x + y * y
        icdist = (1 + ((k6 * r2 + k5) * r2 + k4) * r2) / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        stop = live & (icdist < 0)
        live &= ~stop
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = np.where(stop, x0, np.where(live, (x0 - dx) * icdist, x))
        y = np.where(stop, y0, np.where(live, (y0 - dy) * icdist, y))
    xx = RR[0, 0] * x + RR[0, 1] * y + RR[0, 2]
    yy = RR[1, 0] * x + RR[1, 1] * y + RR[1, 2]
    ww = 1.0 / (RR[2, 0] * x + RR[2, 1] * y + RR[2, 2])
    return np.stack([xx * ww, yy * ww], axis=-1)


def _inner_rectangle(K, dist, R, P, image_size):
    """The valid inner rectangle (x, y, width, height) of the rectified view:
    a 9 x 9 grid over the raw image (0 .. size - 1) undistorted into it, the
    largest rectangle inside its border points (OpenCV's getRectangles)."""
    w, h = image_size
    n = 9
    ys, xs = np.mgrid[0:n, 0:n]
    grid = np.stack([xs * (w - 1) / (n - 1), ys * (h - 1) / (n - 1)], -1).reshape(-1, 2)
    p = undistort_points(grid, K, dist, R, P).reshape(n, n, 2)
    x0, x1 = p[:, 0, 0].max(), p[:, n - 1, 0].min()
    y0, y1 = p[0, :, 1].max(), p[n - 1, :, 1].min()
    return x0, y0, x1 - x0, y1 - y0


def stereo_rectify(K1, D1, K2, D2, image_size, R, T):
    """cv2.stereoRectify(K1, D1, K2, D2, image_size, R, T,
    flags=CALIB_ZERO_DISPARITY, alpha=0) in numpy: (R1, R2, P1, P2, Q).

    Each camera turns by half the stereo rotation, then both by the rotation
    that takes the baseline onto the x (or y) axis. The common focal length
    starts as the mean of the two cameras' fy (fx for vertical stereo) and
    the principal point as the mean of both cameras' centring of their
    undistorted corners (zero disparity); alpha = 0 then scales the focal
    length so that each view's valid inner rectangle fills the image, with
    no black border. image_size is (width, height)."""
    K1, K2 = np.asarray(K1, np.float64), np.asarray(K2, np.float64)
    nx, ny = image_size
    T = np.asarray(T, np.float64).ravel()
    r_r = rodrigues_to_matrix(rodrigues_to_vector(R) * -0.5)
    t = r_r @ T
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c, nt = t[idx], np.linalg.norm(t)
    if not nt > 0:
        raise ValueError("stereo_rectify: the translation between the cameras is zero")
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0:
        ww = ww * (np.arccos(abs(c) / nt) / nw)
    wR = rodrigues_to_matrix(ww)
    R1, R2 = wR @ r_r.T, wR @ r_r
    t = R2 @ T

    fc = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * 0.5
    corners = np.array([[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]], np.float32)
    cc = np.empty((2, 2))
    for k, (K, D, Rk) in enumerate(((K1, D1, R1), (K2, D2, R2))):
        # OpenCV keeps these points in float32 through undistortion and projection
        pn = undistort_points(corners, K, D).astype(np.float32).astype(np.float64)
        X = np.c_[pn, np.ones(4)] @ Rk.T
        proj = (fc * X[:, :2] / X[:, 2:]).astype(np.float32)
        cc[k] = np.array([nx - 1, ny - 1]) / 2 - proj.astype(np.float64).mean(0)
    cc[:] = cc.mean(0)  # CALIB_ZERO_DISPARITY: one principal point for both

    P1 = np.zeros((3, 4))
    P1[0, 0] = P1[1, 1] = fc
    P1[:2, 2] = cc[0]
    P1[2, 2] = 1.0
    P2 = P1.copy()
    P2[:2, 2] = cc[1]
    P2[idx, 3] = t[idx] * fc

    s = -np.inf  # alpha = 0: the largest scale any inner-rectangle side asks for
    for (K, D, Rk, P), (cx, cy) in zip(((K1, D1, R1, P1), (K2, D2, R2, P2)), cc):
        ix, iy, iw, ih = _inner_rectangle(K, D, Rk, P, image_size)
        s = max(s, cx / (cx - ix), cy / (cy - iy), (nx - 1 - cx) / (ix + iw - cx),
                (ny - 1 - cy) / (iy + ih - cy))
    fc *= s
    for P in (P1, P2):
        P[0, 0] = P[1, 1] = fc
    P2[idx, 3] *= s
    (cx1, cy1), (cx2, cy2) = cc
    Q = np.array([[1.0, 0, 0, -cx1],
                  [0, 1.0, 0, -cy1],
                  [0, 0, 0, fc],
                  [0, 0, -1.0 / t[idx], (cx1 - cx2 if idx == 0 else cy1 - cy2) / t[idx]]])
    return R1, R2, P1, P2, Q


def init_undistort_rectify_map(K, dist, R, P, image_size, rows=16):
    """cv2.initUndistortRectifyMap(K, dist, R, P, image_size, CV_32FC1) in
    numpy: for each rectified pixel, the raw pixel it samples, as float32
    (map_x, map_y) of shape (height, width). Computed in float64 blocks of
    `rows` rows, which stay in the CPU's cache (about 3x faster than whole
    images at 1216x1024; the same values)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = distortion_coefficients(dist)
    K = np.asarray(K, np.float64)
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ir = np.linalg.inv(np.asarray(P, np.float64)[:, :3] @ np.asarray(R, np.float64))
    w, h = image_size
    map_x = np.empty((h, w), np.float32)
    map_y = np.empty((h, w), np.float32)
    j = np.arange(w, dtype=np.float64)[None, :]
    for r0 in range(0, h, rows):
        i = np.arange(r0, min(h, r0 + rows), dtype=np.float64)[:, None]
        wi = 1.0 / (i * ir[2, 1] + ir[2, 2] + j * ir[2, 0])
        x = (i * ir[0, 1] + ir[0, 2] + j * ir[0, 0]) * wi
        y = (i * ir[1, 1] + ir[1, 2] + j * ir[1, 0]) * wi
        x2, y2 = x * x, y * y
        r2 = x2 + y2
        _2xy = 2 * x * y
        kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
        map_x[r0:r0 + rows] = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + u0
        map_y[r0:r0 + rows] = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + v0
    return map_x, map_y


def compute_stereo_rectification(calibration_data, image_size, delta_R=None):
    """Zero-disparity, alpha = 0 stereo rectification and the float32
    undistort-rectify maps of both cameras, in numpy (the JAX package's
    version calls cv2.stereoRectify and cv2.initUndistortRectifyMap).
    image_size is (width, height); delta_R, when given, right-multiplies the
    stereo rotation."""
    K1 = build_camera_matrix(**{k: calibration_data["left"][k]
                                for k in ("fx", "fy", "cx", "cy")})
    K2 = build_camera_matrix(**{k: calibration_data["right"][k]
                                for k in ("fx", "fy", "cx", "cy")})
    D1 = calibration_data["left"]["distortion"]
    D2 = calibration_data["right"]["distortion"]
    R = np.asarray(calibration_data["stereo_extrinsic"]["rotation"], np.float64)
    T = np.asarray(calibration_data["stereo_extrinsic"]["translation"],
                   np.float64).reshape(3, 1)
    if R.shape != (3, 3):
        raise ValueError(f"stereo rotation must be 3x3, got {R.shape}")
    if delta_R is not None:
        R = R @ delta_R
    R1, R2, P1, P2, Q = stereo_rectify(K1, D1, K2, D2, image_size, R, T)
    leftMapX, leftMapY = init_undistort_rectify_map(K1, D1, R1, P1, image_size)
    rightMapX, rightMapY = init_undistort_rectify_map(K2, D2, R2, P2, image_size)
    return {"K1": K1, "D1": D1, "K2": K2, "D2": D2, "R": R, "T": T,
            "R1": R1, "R2": R2, "P1": P1, "P2": P2, "Q": Q,
            "leftMapX": leftMapX, "leftMapY": leftMapY,
            "rightMapX": rightMapX, "rightMapY": rightMapY}


# --- dataset calibration parsers -------------------------------------------

def read_middlebury_calib(path):
    """Middlebury calib.txt: cam0/cam1 3x3 matrices, doffs, baseline, dims
    (reference: demo/visualize_3d_middlebury.py:54-69)."""
    calib = {}
    with open(path) as f:
        for line in f:
            if "=" not in line:
                continue
            key, val = line.strip().split("=", 1)
            if val.startswith("["):
                rows = val.strip("[]").split(";")
                mat = np.array([[float(x) for x in r.split()] for r in rows])
                calib[key] = mat
            else:
                try:
                    calib[key] = float(val)
                except ValueError:
                    calib[key] = val
    return calib


def read_opencv_calib_xml(path):
    """Booster-style calib.xml via cv2.FileStorage
    (reference: demo/visualize_3d_booster.py:54-61): matrices as arrays,
    scalars (baseline, doffs) as floats. (The JAX package's copy calls
    node.mat() on scalar nodes too, which OpenCV 5 refuses.)"""
    import cv2
    fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_READ)
    out = {}
    for key in ("M1", "M2", "D1", "D2", "R", "T", "baseline", "doffs",
                "mtxL", "mtxR"):
        node = fs.getNode(key)
        if node.empty():
            continue
        out[key] = node.mat() if node.isMap() else node.real()
    fs.release()
    return out
