"""The port's native preprocessing library (s2m2_torch/native, built with g++
into build/s2m2_torch/ at first use) against cv2.remap, its numpy versions
(`remap_plain`, `image_pad_plain`) and the JAX package's `image_pad`; a
broken compiler raises instead of falling back to numpy."""
import os

import cv2
import numpy as np
import pytest

from s2m2_torch import native
from s2m2_torch.utils.image import image_pad, image_pad_plain, remap_plain


def _maps(rng, h_in, w_in, h_out, w_out):
    # coordinates up to 2 px outside on every side: the zero border counts
    mx = rng.uniform(-2, w_in + 2, (h_out, w_out)).astype(np.float32)
    my = rng.uniform(-2, h_in + 2, (h_out, w_out)).astype(np.float32)
    return mx, my


@pytest.mark.parametrize("channels", [3, 1, 0])
def test_native_remap_matches_cv2_and_plain(channels):
    rng = np.random.default_rng(channels)
    shape = (64, 80, channels) if channels else (64, 80)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    mx, my = _maps(rng, 64, 80, 50, 70)
    ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT)
    ref = ref.reshape(mx.shape + shape[2:])  # cv2 drops a single channel axis
    got = native.remap_bilinear(img, mx, my)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    plain = remap_plain(img, mx, my)
    assert plain.dtype == np.uint8 and plain.shape == ref.shape
    assert np.abs(got.astype(int) - plain.astype(int)).max() <= 1


def test_remap_plain_matches_cv2(rng):
    """The numpy remap (the native one's plain version): uint8 within 1 grey
    level and float32 within 1e-3 of cv2.remap."""
    img = rng.uniform(0, 255, (32, 40, 3)).astype(np.uint8)
    mx, my = _maps(rng, 32, 40, 30, 35)
    ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT)
    assert np.abs(remap_plain(img, mx, my).astype(int) - ref.astype(int)).max() <= 1
    f = img.astype(np.float32) + rng.uniform(0, 1, img.shape).astype(np.float32)
    ref = cv2.remap(f, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT)
    got = remap_plain(f, mx, my)
    assert got.dtype == np.float32 and np.abs(got - ref).max() <= 1e-3


def test_native_remap_rejects_float_and_bad_maps():
    img = np.zeros((8, 8, 3), np.float32)
    mx = np.zeros((4, 4), np.float32)
    with pytest.raises(TypeError):
        native.remap_bilinear(img, mx, mx)
    with pytest.raises(ValueError):
        native.remap_bilinear(img.astype(np.uint8), mx, mx[:2])


@pytest.mark.parametrize("hw", [(100, 130), (45, 77), (20, 33), (1000, 1200)])
def test_native_pad_matches_plain_and_jax(hw):
    from s2m2_tpu.utils.image import image_pad as jax_image_pad
    rng = np.random.default_rng(hw[0])
    img = rng.uniform(0, 255, (1, *hw, 3)).astype(np.float32)
    got = native.image_pad(img[0], 32)
    want = image_pad_plain(img, 32)[0]
    assert got.shape == want.shape == (-(-hw[0] // 32) * 32, -(-hw[1] // 32) * 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(image_pad(img, 32), jax_image_pad(img, 32), atol=1e-3)
    np.testing.assert_array_equal(image_pad(img, 32)[0], got)


def _fresh_build_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)


@pytest.mark.parametrize("cxx", ["false", "/nonexistent/g++"])
def test_broken_compiler_raises(monkeypatch, tmp_path, cxx):
    _fresh_build_dir(monkeypatch, tmp_path)
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError):
        native.build()
    with pytest.raises(RuntimeError):  # the wrappers build first, with no fallback
        native.remap_bilinear(np.zeros((4, 4), np.uint8), *[np.zeros((2, 2), np.float32)] * 2)
    assert not native.library_path().exists()
    assert [p.name for p in tmp_path.iterdir()] == ["libs2m2_preprocess.lock"]


def test_rebuilds_when_source_is_newer(monkeypatch, tmp_path):
    _fresh_build_dir(monkeypatch, tmp_path)
    monkeypatch.delenv("CXX", raising=False)
    native.build()
    lib = native.library_path()
    assert lib.exists()
    src_mtime = native.SOURCE.stat().st_mtime
    os.utime(lib, (src_mtime - 10, src_mtime - 10))
    native.build()
    assert lib.stat().st_mtime >= src_mtime  # compiled again
    before = lib.stat().st_mtime_ns
    native.build()  # up to date: left alone
    assert lib.stat().st_mtime_ns == before
