"""s2m2_torch engine on the CPU, and the port's independence from JAX."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from s2m2_torch.config import ModelConfig
from s2m2_torch.runtime.engine import StereoEngine
from s2m2_torch.utils.image import image_crop, image_pad

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ModelConfig(feature_channels=16, num_transformer=1, refine_iter=1)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_engine_pads_crops_and_scores(precision):
    rng = np.random.default_rng(0)
    h, w = 210, 230  # pads to 224 x 256; the 100 px interior exists
    left = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    right = np.roll(left, -6, axis=1)
    eng = StereoEngine(SMALL, precision=precision, device="cpu")
    disp, occ, conf, score, ms = eng.run(left, right)
    for m in (disp, occ, conf):
        assert m.shape == (h, w) and m.dtype == np.float32 and np.isfinite(m).all()
    assert disp.min() >= 0 and 0 <= occ.min() and occ.max() <= 1
    assert 0 <= conf.min() and conf.max() <= 1
    assert score == pytest.approx(float(conf[100:-100, 100:-100].mean()), rel=1e-6)
    assert ms > 0
    # the batched form gives the same maps
    d2, _, _, _, _ = eng.run(left[None], right[None])
    assert d2.shape == (1, h, w)
    np.testing.assert_array_equal(d2[0], disp)


def test_engine_keeps_fp32_islands_in_bf16():
    eng = StereoEngine(SMALL, precision="bf16", device="cpu")
    dtypes = {n: p.dtype for n, p in eng.model.named_parameters()}
    assert dtypes["refiner.disp_update.2.weight"] == torch.float32
    assert dtypes["global_refiner.out_feat.0.bias"] == torch.float32
    assert dtypes["refiner.disp_update.0.weight"] == torch.bfloat16
    assert not torch.backends.cudnn.allow_tf32


def test_engine_rejects_int8_and_missing_cuda():
    """An int8 engine never serves without scales (it calibrates first or
    raises); unknown precisions and a missing card raise."""
    eng = StereoEngine(SMALL, precision="int8", device="cpu")
    img = torch.zeros((1, 64, 64, 3))
    with pytest.raises(RuntimeError, match="not calibrated"):
        eng._forward(img, img)
    with pytest.raises(ValueError):
        StereoEngine(SMALL, precision="fp16", device="cpu")
    with pytest.raises(ValueError):
        StereoEngine(SMALL, precision="int4", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StereoEngine(SMALL)  # the default device is the card
        with pytest.raises(RuntimeError):
            StereoEngine(SMALL, device="cpu").benchmark(64, 64)


def test_engine_loads_npz_and_pth_checkpoints(tmp_path):
    from s2m2_torch.tools.convert import load_npz
    path = os.path.join(ROOT, "tests", "golden", "s2m2_c32_ntr1.npz")
    cfg = ModelConfig(feature_channels=32, num_transformer=1, refine_iter=2)
    want = load_npz(path)
    pth = str(tmp_path / "CH32NTR1.pth")
    torch.save({"state_dict": want}, pth)  # the reference's checkpoint format
    for ckpt in (path, pth):
        eng = StereoEngine(cfg, checkpoint=ckpt, precision="fp32", device="cpu")
        got = eng.model.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def test_image_pad_crop_round_trip():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (2, 50, 70, 3)).astype(np.float32)
    padded = image_pad(img)
    assert padded.shape == (2, 64, 96, 3)
    np.testing.assert_array_equal(image_crop(padded, (50, 70)), img)
    np.testing.assert_array_equal(image_pad(padded), padded)  # already aligned


def test_image_pad_matches_jax_package():
    import s2m2_tpu.utils.image as jax_image
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (1, 45, 77, 3)).astype(np.float32)
    # the JAX package takes its native fast path when that library is built;
    # both paths implement the same blurred fill
    np.testing.assert_allclose(image_pad(img), jax_image.image_pad(img), atol=1e-3)


def test_package_imports_no_jax():
    code = ("import sys, s2m2_torch.runtime.engine, s2m2_torch.ops.flash_attention, "
            "s2m2_torch.ops.sinkhorn, s2m2_torch.tools.convert, s2m2_torch.native, "
            "s2m2_torch.utils.calib, s2m2_torch.utils.metrics, "
            "s2m2_torch.utils.pointcloud, s2m2_torch.utils.vis, "
            "s2m2_torch.calibration.base, s2m2_torch.calibration.cem, "
            "s2m2_torch.calibration.grad_descent, s2m2_torch.calibration.keypoint, "
            "s2m2_torch.calibration.visualize, s2m2_torch.tools.bench, "
            "s2m2_torch.tools.eval_dataset; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'s2m2_tpu'))]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_calibration_path_imports_no_cv2():
    """The calibration search, rectification and engine need no OpenCV, even
    where it is installed: importing them and rectifying a uint8 pair leaves
    cv2 out of sys.modules."""
    code = ("import sys, numpy as np, s2m2_torch.calibration.cem, "
            "s2m2_torch.calibration.grad_descent, s2m2_torch.utils.calib as C, "
            "s2m2_torch.runtime.engine; "
            "from s2m2_torch.utils.image import rectify_images; "
            "d = {'fx': 80.0, 'fy': 80.0, 'cx': 40.0, 'cy': 30.0, "
            "'distortion': np.array([-0.05, 0.01, 0, 0, 0])}; "
            "data = {'left': d, 'right': d, 'stereo_extrinsic': {'rotation': np.eye(3), "
            "'translation': np.array([-120.0, 0, 0])}}; "
            "img = np.zeros((60, 80, 3), np.uint8); "
            "rectify_images(img, img, C.compute_stereo_rectification(data, (80, 60))); "
            "bad = [m for m in sys.modules if m == 'cv2' or m.startswith('cv2.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_run_n_repeat(precision):
    """run(n_repeat=4): one untimed forward, then 4 on the same padded pair;
    the same maps as run(n_repeat=1) within the bf16 drift bound
    (tests/test_model_parity.py:115: mean |disp diff| < 0.01 px) and a
    positive mean time; n_repeat < 1 raises."""
    rng = np.random.default_rng(4)
    left = rng.uniform(0, 255, (70, 90, 3)).astype(np.float32)
    right = np.roll(left, -4, axis=1)
    eng = StereoEngine(SMALL, precision=precision, device="cpu")
    one = eng.run(left, right, n_repeat=1)
    four = eng.run(left, right, n_repeat=4)
    for a, b in zip(one[:3], four[:3]):
        assert a.shape == b.shape == (70, 90)
        assert float(np.abs(a - b).mean()) < 0.01
    assert abs(one[3] - four[3]) < 1e-3 and four[4] > 0
    with pytest.raises(ValueError):
        eng.run(left, right, n_repeat=0)


def test_sources_never_import_jax():
    """No import statement of jax or s2m2_tpu in the package or chip_smoke.py
    (their docstrings do name s2m2_tpu files, as the reference)."""
    imports = re.compile(r"^\s*(import|from)\s+(jax|s2m2_tpu)\b", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "s2m2_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            if imports.search(f.read()):
                offenders.append(path)
    assert len(files) > 15 and not offenders, offenders
