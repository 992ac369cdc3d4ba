"""The cases of tests/test_utils.py on the port's host-side utilities (metrics,
calibration math and parsers, point clouds, image pad/crop, drawing), each
also compared with the JAX package's function on the same seeded inputs."""
import base64
import re
import textwrap

import numpy as np
import pytest

from s2m2_torch.utils import calib as C
from s2m2_torch.utils import metrics as M
from s2m2_torch.utils import pointcloud as PC
from s2m2_torch.utils import vis as V
from s2m2_torch.utils.image import image_crop, image_pad
from s2m2_tpu.utils import calib as JC
from s2m2_tpu.utils import metrics as JM
from s2m2_tpu.utils import pointcloud as JPC
from s2m2_tpu.utils import vis as JV


def test_epe_bad(rng):
    gt = rng.uniform(0, 50, (32, 32))
    pred = gt + 1.0
    assert abs(M.epe(pred, gt) - 1.0) < 1e-9
    assert M.bad_ratio(pred, gt, 2.0) == 0.0
    assert M.bad_ratio(pred, gt, 0.5) == 1.0
    gt2 = gt.copy()
    gt2[0, :] = np.nan
    assert np.isfinite(M.epe(pred, gt2))


def test_metrics_equal_jax():
    g = np.random.default_rng(3)
    gt = g.uniform(1, 60, (40, 50))
    gt[:3] = np.nan
    pred = gt + g.normal(0, 2, gt.shape)
    conf = g.uniform(0, 1, gt.shape)
    valid = g.uniform(0, 1, gt.shape) > 0.2
    for v in (None, valid):
        assert M.evaluate_pair(pred, gt, conf, v) == JM.evaluate_pair(pred, gt, conf, v)
    assert np.isnan(M.epe(pred, gt, np.zeros_like(valid)))


def test_confidence_auc_orders():
    gt = np.zeros((10, 10))
    pred = np.zeros((10, 10))
    pred[:5] = 5.0
    good_conf = np.ones((10, 10))
    good_conf[:5] = 0.0
    bad_conf = 1 - good_conf
    auc_good = M.confidence_auc(pred, gt, good_conf)
    auc_bad = M.confidence_auc(pred, gt, bad_conf)
    assert auc_good < auc_bad
    assert auc_good == JM.confidence_auc(pred, gt, good_conf)


def test_rotation_roundtrip():
    r, p, y = 0.01, -0.02, 0.005
    R = C.euler_to_rotation_matrix(r, p, y)
    np.testing.assert_array_equal(R, JC.euler_to_rotation_matrix(r, p, y))
    assert C.validate_rotation_matrix(R)
    rr, pp, yy = C.rotation_matrix_to_euler(R)
    np.testing.assert_allclose([rr, pp, yy], [r, p, y], atol=1e-10)
    Rs = C.small_angle_rotation_to_matrix([r, p, y])
    np.testing.assert_allclose(Rs, R, atol=5e-4)
    np.testing.assert_array_equal(C.axis_angle_to_rotation_matrix([0, 0, 1], 0.3),
                                  JC.axis_angle_to_rotation_matrix([0, 0, 1], 0.3))
    assert not C.validate_rotation_matrix(np.eye(2))


XML = textwrap.dedent("""\
    <calib>
      <distorted_left_intrinsic>
        <fx>800.0</fx><fy>801.0</fy><cx>320.0</cx><cy>240.0</cy>
        <dist>0.1, -0.05, 0.001, 0.002, 0.0</dist>
      </distorted_left_intrinsic>
      <distorted_right_intrinsic>
        <fx>802.0</fx><fy>803.0</fy><cx>321.0</cx><cy>241.0</cy>
        <dist>0.1, -0.05, 0.001, 0.002, 0.0</dist>
      </distorted_right_intrinsic>
      <distorted_rgb_intrinsic>
        <fx>900.0</fx><fy>901.0</fy><cx>322.0</cx><cy>242.0</cy>
        <dist>0.0, 0.0, 0.0, 0.0, 0.0</dist>
      </distorted_rgb_intrinsic>
      <stereo_extrinsic>
        <rotation>1,0,0, 0,1,0, 0,0,1</rotation>
        <translation>-100.0, 0.0, 0.0</translation>
      </stereo_extrinsic>
      <left2rgb>
        <rotation>1,0,0, 0,1,0, 0,0,1</rotation>
        <translation>-50.0, 0.0, 0.0</translation>
      </left2rgb>
    </calib>""")


def test_xml_calibration_roundtrip(tmp_path, capsys):
    path = tmp_path / "calib.xml"
    path.write_text(XML)
    data = C.parse_xml_calibration(str(path))
    assert data["left"]["fx"] == 800.0
    assert data["stereo_extrinsic"]["translation"][0] == -100.0
    assert data["rgb"]["cy"] == 242.0
    want = JC.parse_xml_calibration(str(path))
    for name in ("left", "right", "rgb"):
        for k, v in want[name].items():
            np.testing.assert_array_equal(data[name][k], v)
    rect = C.compute_stereo_rectification(data, (64, 48))
    assert rect["leftMapX"].shape == (48, 64)
    assert rect["Q"].shape == (4, 4)
    # the tolerant loader: a missing or broken file gives None
    assert C.load_calibration_data(str(tmp_path / "absent.xml")) is None
    (tmp_path / "broken.xml").write_text("<calib>")
    assert C.load_calibration_data(str(tmp_path / "broken.xml")) is None
    assert C.load_calibration_data(str(path))["left"]["fy"] == 801.0


def test_middlebury_calib(tmp_path):
    txt = ("cam0=[3979.911 0 1244.772; 0 3979.911 1019.507; 0 0 1]\n"
           "cam1=[3979.911 0 1369.115; 0 3979.911 1019.507; 0 0 1]\n"
           "doffs=124.343\nbaseline=193.001\nwidth=2964\nheight=1988\nname=x\n")
    p = tmp_path / "calib.txt"
    p.write_text(txt)
    calib = C.read_middlebury_calib(str(p))
    assert calib["cam0"].shape == (3, 3)
    assert calib["baseline"] == 193.001
    assert calib["doffs"] == 124.343
    want = JC.read_middlebury_calib(str(p))
    assert set(calib) == set(want)
    np.testing.assert_array_equal(calib["cam1"], want["cam1"])
    assert calib["name"] == want["name"] == "x"


def test_opencv_calib_xml(tmp_path):
    """Matrices as the JAX package reads them; scalars as floats (the JAX
    package's reader fails on them under OpenCV 5)."""
    import cv2
    path = str(tmp_path / "calib.xml")
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    fs.write("M1", np.eye(3) * 2)
    fs.write("D1", np.arange(5, dtype=np.float64))
    fs.release()
    got, want = C.read_opencv_calib_xml(path), JC.read_opencv_calib_xml(path)
    assert set(got) == set(want) == {"M1", "D1"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_APPEND)
    fs.write("baseline", 0.25)
    fs.release()
    got = C.read_opencv_calib_xml(path)
    assert got["baseline"] == 0.25 and got["M1"].shape == (3, 3)


def test_depth_and_pointcloud(tmp_path):
    disp = np.full((24, 32), 10.0, np.float32)
    disp[0, 0] = -1
    depth = PC.disparity_to_depth(disp, fx=100.0, baseline=50.0, doffs=0.0)
    assert depth[1, 1] == pytest.approx(500.0)
    assert depth[0, 0] == 1e9
    calib = {"cam0": np.array([[100.0, 0, 16], [0, 100.0, 12], [0, 0, 1]]),
             "baseline": 50.0, "doffs": 0.0}
    rgb = np.random.default_rng(4).integers(0, 255, (24, 32, 3), dtype=np.uint8)
    pts, cols = PC.get_pointcloud(rgb, disp, calib)
    assert pts.shape[1] == 3 and len(pts) == len(cols)
    want_pts, want_cols = JPC.get_pointcloud(rgb, disp, calib, stride=1)
    np.testing.assert_array_equal(pts, want_pts)
    np.testing.assert_array_equal(cols, want_cols)
    np.testing.assert_array_equal(PC.get_pointcloud(rgb, disp, calib, 0.4, 2)[0],
                                  JPC.get_pointcloud(rgb, disp, calib, 0.4, 2)[0])
    ply, jply = tmp_path / "out.ply", tmp_path / "jax.ply"
    PC.save_ply(str(ply), pts, cols)
    JPC.save_ply(str(jply), pts, cols)
    assert ply.read_text().startswith("ply")
    assert ply.read_text() == jply.read_text()
    PC.save_ply(str(ply), pts)
    JPC.save_ply(str(jply), pts)
    assert ply.read_text() == jply.read_text()


def test_html_viewer_roundtrip(tmp_path, rng):
    """save_html_viewer embeds the (possibly subsampled) cloud base64-exact
    and the page's projection matrix math is mirrored here: the cloud
    centroid must project to the NDC center with positive clip w."""
    pts = rng.standard_normal((5000, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (5000, 3)).astype(np.float32)
    path = tmp_path / "cloud.html"
    PC.save_html_viewer(str(path), pts, cols, max_points=1000)
    html = path.read_text()
    b64 = re.search(r'atob\("([^"]*)"\), c => c\.charCodeAt', html).group(1)
    got = np.frombuffer(base64.b64decode(b64), np.float32).reshape(-1, 3)
    assert len(got) == 1000
    idx = np.linspace(0, len(pts) - 1, 1000).astype(np.int64)
    np.testing.assert_array_equal(got, pts[idx])
    assert "1000 points" in html and "webgl" in html
    jpath = tmp_path / "jax.html"
    JPC.save_html_viewer(str(jpath), pts, cols, max_points=1000)
    title = re.compile(r"<title>[^<]*</title>")
    assert title.sub("", html) == title.sub("", jpath.read_text())

    ctr = (got.min(0) + got.max(0)) / 2
    rad = max(got.max(0) - got.min(0)) / 2
    yaw, pitch, dist = 0.5, -0.4, 2.5 * rad
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    R = np.array([[cy, 0, -sy], [sy * sp, cp, cy * sp], [sy * cp, -sp, cy * cp]])
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    v = R @ ctr - R @ ctr + np.array([0.0, 0.0, -dist])
    assert v[2] < 0
    near, far = rad / 100, rad * 100
    zz, zw = (far + near) / (near - far), 2 * far * near / (near - far)
    ndc = np.array([1.5 * v[0], 1.5 * v[1], zz * v[2] + zw]) / -v[2]
    np.testing.assert_allclose(ndc[:2], 0, atol=1e-6)
    assert -1 <= ndc[2] <= 1


def test_image_pad_blurred_fill(rng):
    img = rng.uniform(0, 255, (1, 100, 130, 3)).astype(np.float32)
    pad = image_pad(img, 32)
    assert pad.shape == (1, 128, 160, 3)
    hs, ws = (128 - 100) // 2, (160 - 130) // 2
    np.testing.assert_array_equal(pad[:, hs:hs + 100, ws:ws + 130], img)
    assert np.abs(pad[:, :hs]).sum() > 0
    crop = image_crop(pad, (100, 130))
    np.testing.assert_array_equal(crop, img)


def test_image_pad_torch_parity(rng):
    """vs the reference image_pad semantics via a torch oracle."""
    import torch
    import torch.nn.functional as F
    img = rng.uniform(0, 255, (1, 3, 100, 130)).astype(np.float32)
    t = torch.from_numpy(img)
    H, W = 100, 130
    H_new, W_new = 128, 160
    pad_h, pad_w = H_new - H, W_new - W
    tp = F.pad(t, (pad_w // 2, pad_w - pad_w // 2, 0, 0))
    tp = F.pad(tp, (0, 0, pad_h // 2, pad_h - pad_h // 2))
    down = F.adaptive_avg_pool2d(tp, output_size=[H // 32, W // 32])
    ref = F.interpolate(down, size=[H_new, W_new], mode="bilinear")
    ref[:, :, pad_h // 2:-(pad_h - pad_h // 2),
        pad_w // 2:-(pad_w - pad_w // 2)] = t
    got = image_pad(np.transpose(img, (0, 2, 3, 1)), 32)
    np.testing.assert_allclose(got, ref.numpy().transpose(0, 2, 3, 1), atol=1e-4)


def test_drawing_equals_jax():
    g = np.random.default_rng(5)
    disp = g.uniform(0, 40, (24, 32)).astype(np.float32)
    occ, conf = g.uniform(0, 1, (2, 24, 32)).astype(np.float32)
    left = g.integers(0, 255, (24, 32, 3), dtype=np.uint8)
    np.testing.assert_array_equal(V.apply_colormap(disp), JV.apply_colormap(disp))
    np.testing.assert_array_equal(V.validity_mask(conf, occ), JV.validity_mask(conf, occ))
    np.testing.assert_array_equal(V.draw_epipolar_lines(left, left, 5),
                                  JV.draw_epipolar_lines(left, left, 5))
    panel = V.render_results_2d(left, disp, occ, conf)
    assert panel.shape == (24, 96, 3) and panel.dtype == np.uint8
    np.testing.assert_array_equal(panel, JV.render_results_2d(left, disp, occ, conf))
