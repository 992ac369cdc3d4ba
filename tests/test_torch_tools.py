"""The port's offline int8 calibration cache (tools/calibrate.py) and
weight fetching (tools/fetch_weights.py), on the CPU; fetching is tested
only against a local file:// mirror, as tests/test_fetch_weights.py does."""
import os
import pathlib

import numpy as np
import pytest
import torch

from s2m2_torch.config import ModelConfig
from s2m2_torch.runtime.engine import StereoEngine
from s2m2_torch.tools import calibrate, fetch_weights

torch.set_num_threads(2)
CFG = ModelConfig(feature_channels=32, num_transformer=1, refine_iter=2)


def _pair(seed, h=96, w=128):
    from s2m2_torch.train.data import _random_scene
    left, right, _ = _random_scene(np.random.default_rng(seed), h, w, max_disp=16)
    return left, right


def test_calibration_cache_reproduces_the_self_calibrated_disparity(tmp_path):
    """calibrate_engine on its synthetic default pair, the scales saved; a
    fresh engine that loads the .npy gives, on another pair, the disparity
    of the engine that calibrated itself, to the bit."""
    eng = StereoEngine(CFG, precision="int8", device="cpu")
    scales = calibrate.calibrate_engine(eng, max_hw=256)
    path = tmp_path / "calib.npy"
    eng.save_calibration(path)
    np.testing.assert_array_equal(np.load(path), scales)
    fresh = StereoEngine(CFG, precision="int8", device="cpu")
    fresh.load_calibration(path)
    left, right = _pair(1)
    np.testing.assert_array_equal(fresh.run(left, right)[0], eng.run(left, right)[0])


def test_calibration_over_pairs_takes_the_elementwise_max():
    pairs = [_pair(2), _pair(3)]
    each = [calibrate.calibrate_engine(StereoEngine(CFG, precision="int8", device="cpu"),
                                       [p]) for p in pairs]
    both = calibrate.calibrate_engine(StereoEngine(CFG, precision="int8", device="cpu"),
                                      pairs)
    np.testing.assert_array_equal(both, np.maximum(*each))


def test_calibrate_cli_writes_what_load_calibration_reads(tmp_path):
    """The CLI on S (its default model) calibrates on the engine's benchmark
    pair, decimated to --max_hw, and writes scales that equal an in-process
    calibrate_engine on that pair and load into a fresh engine."""
    out = tmp_path / "s_calib.npy"
    assert calibrate.main(["--model", "S", "--out", str(out), "--max_hw", "64",
                           "--num_refine", "1", "--device", "cpu"]) == 0
    eng = StereoEngine("S", precision="int8", refine_iter=1, device="cpu")
    pair = tuple(x[0] for x in eng._benchmark_calib_pair())
    want = calibrate.calibrate_engine(eng, [pair], max_hw=64)
    np.testing.assert_array_equal(np.load(out), want)
    fresh = StereoEngine("S", precision="int8", refine_iter=1, device="cpu")
    assert len(fresh.load_calibration(out)) == len(want)


def test_calibrate_cli_rejects_an_odd_image_list(tmp_path):
    with pytest.raises(SystemExit):
        calibrate.main(["--out", str(tmp_path / "x.npy"), "--images", "a.png",
                        "--device", "cpu"])


def _make_fake_pth(path):
    """A minimal {'state_dict': ...} pickle: a conv weight, its bias, a
    linear weight and a transposed-conv weight."""
    rng = np.random.default_rng(0)
    sd = {"cnn_backbone.conv0.0.weight": torch.from_numpy(
              rng.standard_normal((16, 3, 1, 1)).astype(np.float32)),
          "cnn_backbone.conv0.0.bias": torch.zeros(16),
          "transformer.uformer_list.0.enc_attn0.self_attn.attn.q.weight": torch.from_numpy(
              rng.standard_normal((8, 4)).astype(np.float32)),
          "upsample_mask_1x.conv_ctx.weight": torch.from_numpy(
              rng.standard_normal((4, 16, 2, 2)).astype(np.float32))}
    torch.save({"state_dict": sd}, path)


def test_fetch_downloads_and_converts_as_the_jax_tool_does(tmp_path):
    from s2m2_tpu.tools.convert_checkpoint import convert_pth
    src = tmp_path / "mirror"
    src.mkdir()
    _make_fake_pth(src / fetch_weights.checkpoint_filename("S"))
    out = tmp_path / "weights"
    url_base = pathlib.Path(src).as_uri()
    npz = fetch_weights.fetch("S", str(out), url_base=url_base, progress=lambda *a: None)
    assert npz.endswith("CH128NTR1.npz") and os.path.exists(npz)
    convert_pth(str(out / "CH128NTR1.pth"), str(tmp_path / "jax.npz"))
    with np.load(npz) as got, np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
        assert got["cnn_backbone.conv0.0.weight"].shape == (1, 1, 3, 16)
    # a second call is a no-op on existing files (no re-download)
    os.remove(src / fetch_weights.checkpoint_filename("S"))
    assert fetch_weights.fetch("S", str(out), url_base=url_base,
                               progress=lambda *a: None) == npz


def test_fetch_cli_no_convert(tmp_path):
    src = tmp_path / "mirror"
    src.mkdir()
    _make_fake_pth(src / fetch_weights.checkpoint_filename("S"))
    rc = fetch_weights.main(["--model", "S", "--out", str(tmp_path / "w"),
                             "--url-base", pathlib.Path(src).as_uri(), "--no-convert"])
    assert rc == 0
    assert (tmp_path / "w" / "CH128NTR1.pth").exists()
    assert not (tmp_path / "w" / "CH128NTR1.npz").exists()


def test_checkpoint_filenames_match_the_jax_tool():
    from s2m2_tpu.tools import fetch_weights as jfetch
    assert fetch_weights.HF_BASE == jfetch.HF_BASE
    for m in ("S", "M", "L", "XL"):
        assert fetch_weights.checkpoint_filename(m) == jfetch.checkpoint_filename(m)
    assert fetch_weights.checkpoint_filename("XL") == "CH384NTR3.pth"
