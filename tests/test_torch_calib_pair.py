"""The port engine's benchmark calibration pair against the JAX engine's
choice (s2m2_tpu/runtime/engine.py `_benchmark_calib_pair`): a named pair
from S2M2_CALIB_PAIR read as the JAX package reads it, a missing file
raising, and the seed-7 synthetic scene when the variable is unset. The
static method is called directly: no engine is built and no forward runs."""
import logging

import cv2
import numpy as np
import pytest

from s2m2_torch.runtime.engine import StereoEngine


def _write_pair(tmp_path, seed):
    g = np.random.default_rng(seed)
    left = g.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    right = np.roll(left, -5, axis=1)
    lp, rp = str(tmp_path / "left.png"), str(tmp_path / "right.png")
    cv2.imwrite(lp, left[..., ::-1])  # cv2 writes BGR
    cv2.imwrite(rp, right[..., ::-1])
    return lp, rp, left, right


def test_named_pair_equals_jax_read_images(tmp_path, monkeypatch, caplog):
    from s2m2_tpu.utils.image import read_images as jax_read_images
    lp, rp, left, right = _write_pair(tmp_path, 0)
    monkeypatch.setenv("S2M2_CALIB_PAIR", f"{lp}:{rp}")
    with caplog.at_level(logging.WARNING, logger="s2m2_torch.engine"):
        got_l, got_r = StereoEngine._benchmark_calib_pair()
    want_l, want_r = jax_read_images(lp, rp)
    assert got_l.dtype == np.float32 and got_l.shape == (1, 40, 56, 3)
    np.testing.assert_array_equal(got_l[0], np.asarray(want_l, np.float32))
    np.testing.assert_array_equal(got_r[0], np.asarray(want_r, np.float32))
    np.testing.assert_array_equal(got_l[0], left.astype(np.float32))  # PNG is lossless
    np.testing.assert_array_equal(got_r[0], right.astype(np.float32))
    assert len([r for r in caplog.records if lp in r.getMessage()]) == 1


@pytest.mark.parametrize("missing", ["left", "right"])
def test_missing_file_raises(tmp_path, monkeypatch, missing):
    lp, rp, _, _ = _write_pair(tmp_path, 1)
    if missing == "left":
        lp = str(tmp_path / "absent_left.png")
    else:
        rp = str(tmp_path / "absent_right.png")
    monkeypatch.setenv("S2M2_CALIB_PAIR", f"{lp}:{rp}")
    with pytest.raises(FileNotFoundError):
        StereoEngine._benchmark_calib_pair()


def test_unset_gives_the_seed7_scene(monkeypatch, caplog):
    from s2m2_tpu.train.data import _random_scene
    monkeypatch.delenv("S2M2_CALIB_PAIR", raising=False)
    with caplog.at_level(logging.WARNING, logger="s2m2_torch.engine"):
        got_l, got_r = StereoEngine._benchmark_calib_pair()
    want_l, want_r, _ = _random_scene(np.random.default_rng(7), 512, 608, max_disp=96)
    np.testing.assert_array_equal(got_l, want_l[None])
    np.testing.assert_array_equal(got_r, want_r[None])
    assert len([r for r in caplog.records if "synthetic" in r.getMessage()]) == 1
