"""The port's Middlebury and Booster 3D demo CLIs end to end on the CPU at
their synthesized default inputs (a small size, a tiny engine), with neither
cv2 nor PIL importable: calib parse, inference, back-projection, PLY (and
the WebGL page); and each held against the JAX package's demo on the same
files and weights, point for point."""
import numpy as np
import torch

from s2m2_torch.demo import _scenes
from s2m2_torch.demo.visualize_3d_booster import read_booster_calib
from tests.torch_demos import SIZE, TRAINED, TRAINED_CKPT, assert_same_clouds, \
    assert_same_runs, run_cli, run_jax_demo, tiny_engines

torch.set_num_threads(2)


def _ply_points(path):
    with open(path) as f:
        header = [next(f) for _ in range(10)]
    assert header[0] == "ply\n"
    return int(header[2].split()[-1])


def test_middlebury_demo_defaults(tmp_path, monkeypatch, capsys):
    requests = tiny_engines(monkeypatch)
    out, html = tmp_path / "cloud.ply", tmp_path / "cloud.html"
    assert run_cli("visualize_3d_middlebury", ["--out", str(out), "--html", str(html),
                                               "--device", "cpu"], monkeypatch) == 0
    printed = capsys.readouterr().out
    assert "confidence score: " in printed and "runtime" in printed
    assert requests[0][0] == "L" and requests[0][1]["precision"] == "bf16"
    n = _ply_points(out)
    assert f"saved {n} points -> {out}" in printed
    assert 0 < n <= SIZE[0] * SIZE[1]
    page = html.read_text()
    assert "webgl" in page and "points" in page


def test_booster_demo_defaults(tmp_path, monkeypatch, capsys):
    requests = tiny_engines(monkeypatch)
    out = tmp_path / "cloud.ply"
    assert run_cli("visualize_3d_booster", ["--out", str(out), "--device", "cpu"],
                   monkeypatch) == 0
    printed = capsys.readouterr().out
    assert "confidence score: " in printed and "FPS" in printed
    assert requests[0][0] == "XL"
    assert f"saved {_ply_points(out)} points -> {out}" in printed


def test_middlebury_demo_equals_jax(tmp_path, monkeypatch):
    """The port's CLI at its defaults and demo/visualize_3d_middlebury.py
    given the same synthesized files and seeded weights: the same fp32
    outputs and the same cloud, every pixel a point (no mask)."""
    requests = tiny_engines(monkeypatch)
    _scenes.write_defaults("middlebury", str(tmp_path))
    jax_ply, port_ply = tmp_path / "jax.ply", tmp_path / "port.ply"
    jax = run_jax_demo("visualize_3d_middlebury.py",
                       ["--data_dir", str(tmp_path), "--precision", "fp32",
                        "--out", str(jax_ply)], monkeypatch)
    assert run_cli("visualize_3d_middlebury", ["--precision", "fp32", "--out", str(port_ply),
                                               "--device", "cpu"], monkeypatch) == 0
    assert_same_runs(requests[0][2], jax)
    assert assert_same_clouds(port_ply, jax_ply) == int((jax[0][0] > 0).sum())


def test_booster_demo_equals_jax(tmp_path, monkeypatch):
    """The port's CLI at its defaults and demo/visualize_3d_booster.py (cv2's
    FileStorage and resize) given the same synthesized files and the trained
    checkpoint: the same fp32 outputs and the same cloud, which the
    validity mask and the 3 m truncation cut to a part of the pixels."""
    requests = tiny_engines(monkeypatch, TRAINED)
    _scenes.write_defaults("booster", str(tmp_path))
    jax_ply, port_ply = tmp_path / "jax.ply", tmp_path / "port.ply"
    argv = ["--precision", "fp32", "--checkpoint", TRAINED_CKPT]
    jax = run_jax_demo("visualize_3d_booster.py",
                       ["--data_dir", str(tmp_path), "--out", str(jax_ply)] + argv,
                       monkeypatch, TRAINED)
    assert run_cli("visualize_3d_booster", ["--out", str(port_ply), "--device", "cpu"] + argv,
                   monkeypatch) == 0
    assert_same_runs(requests[0][2], jax)
    n = assert_same_clouds(port_ply, jax_ply)
    assert 0 < n < 0.5 * SIZE[0] * SIZE[1]


def test_booster_synthesized_inputs(tmp_path, monkeypatch):
    """The Booster default: twice the scene's size, halved back to it exactly
    by the demo's 0.5x, and a calib.xml the demo reads as written."""
    monkeypatch.setattr(_scenes, "SIZE", SIZE)
    files = _scenes.write_defaults("booster", str(tmp_path))
    from s2m2_torch.utils.image import downscale_half, read_images
    left, right = read_images(files["im0.png"], files["im1.png"])
    assert left.shape == (2 * SIZE[0], 2 * SIZE[1], 3)
    for got, want in zip((left, right), _scenes.scene_pair(*SIZE)):
        np.testing.assert_array_equal(downscale_half(got), want)
    calib = read_booster_calib(files["calib.xml"])
    np.testing.assert_array_equal(calib["cam0"], [[2000.0, 0, SIZE[1]], [0, 2000.0, SIZE[0]],
                                                  [0, 0, 1]])
    assert calib["baseline"] == _scenes.BASELINE_MM and calib["doffs"] == 0.0
