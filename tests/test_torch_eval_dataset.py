"""The port's dataset eval runner (s2m2_torch/tools/eval_dataset.py): the
cases of tests/test_eval_dataset.py on the port's engine, with the PFM reader
and the per-scene metrics held against the JAX package's."""
import json
import os

import numpy as np
import pytest

from s2m2_torch.config import ModelConfig
from s2m2_torch.runtime.engine import StereoEngine
from s2m2_torch.tools import eval_dataset
from s2m2_torch.tools.eval_dataset import eval_scene, read_pfm
from s2m2_tpu.tools.eval_dataset import read_pfm as jax_read_pfm


def write_pfm(path, data, little_endian=True):
    """Middlebury PFM writer (inverse of read_pfm; rows bottom-up)."""
    data = np.asarray(data, np.float32)
    header = "PF" if data.ndim == 3 else "Pf"
    with open(path, "wb") as f:
        f.write(f"{header}\n".encode())
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write((b"-1.0\n" if little_endian else b"1.0\n"))
        flipped = np.flipud(data).astype("<f" if little_endian else ">f")
        f.write(flipped.tobytes())


def test_read_pfm_roundtrip(tmp_path, rng):
    gt = rng.uniform(0, 64, (20, 30)).astype(np.float32)
    for le in (True, False):
        p = tmp_path / f"d_{le}.pfm"
        write_pfm(str(p), gt, little_endian=le)
        np.testing.assert_array_equal(read_pfm(str(p)), gt)
        np.testing.assert_array_equal(read_pfm(str(p)), jax_read_pfm(str(p)))
    rgb = rng.uniform(0, 1, (8, 6, 3)).astype(np.float32)
    p3 = tmp_path / "c.pfm"
    write_pfm(str(p3), rgb)
    np.testing.assert_array_equal(read_pfm(str(p3)), rgb)
    bad = tmp_path / "bad.pfm"
    bad.write_bytes(b"P5\n1 1\n1.0\n\x00\x00\x00\x00")
    with pytest.raises(ValueError):
        read_pfm(str(bad))


def _make_scene(scene_dir, rng, h=64, w=96):
    import cv2
    os.makedirs(scene_dir, exist_ok=True)
    left = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    right = np.roll(left, -3, axis=1)  # crude 3px-shifted pair
    cv2.imwrite(os.path.join(scene_dir, "im0.png"), cv2.cvtColor(left, cv2.COLOR_RGB2BGR))
    cv2.imwrite(os.path.join(scene_dir, "im1.png"), cv2.cvtColor(right, cv2.COLOR_RGB2BGR))
    gt = np.full((h, w), 3.0, np.float32)
    gt[:, :4] = np.inf  # occluded/unknown strip
    write_pfm(os.path.join(scene_dir, "disp0GT.pfm"), gt)
    nocc = np.full((h, w), 255, np.uint8)
    nocc[:, :8] = 0
    cv2.imwrite(os.path.join(scene_dir, "mask0nocc.png"), nocc)


@pytest.fixture(scope="module")
def tiny_engine():
    return StereoEngine(ModelConfig(feature_channels=16, num_transformer=1, refine_iter=1),
                        precision="fp32", device="cpu")


def test_eval_scene(tmp_path, rng, tiny_engine):
    from s2m2_torch.utils.metrics import evaluate_pair
    scene = str(tmp_path / "SceneA")
    _make_scene(scene, rng)
    m = eval_scene(tiny_engine, scene)
    for key in ("epe", "bad_2.0", "conf_score", "runtime_ms"):
        assert key in m and np.isfinite(m[key]), (key, m)
    # the nocc mask is respected: metrics only over its valid pixels
    from s2m2_torch.utils.image import read_images
    pair = read_images(os.path.join(scene, "im0.png"), os.path.join(scene, "im1.png"))
    disp, _, conf, _, _ = tiny_engine.run(*pair)
    gt = read_pfm(os.path.join(scene, "disp0GT.pfm"))
    valid = np.isfinite(gt) & (gt > 0)
    valid[:, :8] = False
    want = evaluate_pair(disp, gt, conf=conf, valid=valid)
    assert {k: m[k] for k in want} == want
    m2 = eval_scene(tiny_engine, scene, downscale=2)
    assert np.isfinite(m2["epe"])


def test_main_runner_aggregates(tmp_path, rng, tiny_engine, monkeypatch):
    for name in ("SceneA", "SceneB"):
        _make_scene(str(tmp_path / name), rng)
    (tmp_path / "not_a_scene").mkdir()  # must be skipped
    broken = tmp_path / "SceneC"  # a ground truth without images: reported, skipped
    broken.mkdir()
    write_pfm(str(broken / "disp0GT.pfm"), np.ones((4, 4), np.float32))

    import s2m2_torch.runtime.engine as engine_mod
    monkeypatch.setattr(engine_mod, "StereoEngine", lambda *a, **k: tiny_engine)
    out = tmp_path / "results.json"
    rc = eval_dataset.main(["--root", str(tmp_path), "--model", "S", "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert set(res["scenes"]) == {"SceneA", "SceneB"}
    assert np.isfinite(res["mean"]["epe"])


def test_main_no_scenes(tmp_path):
    assert eval_dataset.main(["--root", str(tmp_path)]) == 1
