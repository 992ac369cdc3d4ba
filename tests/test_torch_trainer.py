"""The port's trainer, augmentation and directory loader against the JAX
package's (s2m2_tpu/train/{trainer,augment,data}.py) on the CPU."""
import os

import numpy as np
import pytest
import torch

from s2m2_torch.config import ModelConfig
from s2m2_torch.train import augment as taug
from s2m2_torch.train import data as tdata
from s2m2_torch.train.trainer import train
from s2m2_tpu.train import augment as jaug
from s2m2_tpu.train import data as jdata

torch.set_num_threads(2)


def test_train_loss_decreases(tmp_path):
    """tests/test_train.py::test_train_loss_decreases on the port: 8 steps
    under the warmup schedule, a finite loss that drops, the sequence term
    in every record, and the final checkpoint at step 8."""
    cfg = ModelConfig(feature_channels=16, num_transformer=1, refine_iter=1)
    batches = tdata.synthetic_stereo_batches(batch=1, height=64, width=96,
                                             max_disp=12, n_batches=8, seed=0)
    model, optimizer, history = train(cfg, batches, num_steps=8, lr=2e-4, log_every=1,
                                      log=lambda *a: None,
                                      checkpoint_dir=str(tmp_path / "ckpt"),
                                      checkpoint_every=1000, warmup_steps=2,
                                      device="cpu")
    assert len(history) == 8
    assert [h["step"] for h in history] == list(range(8))
    assert all(set(h) >= {"loss", "epe", "loss_seq", "step", "sec"} for h in history)
    assert np.isfinite(history[-1]["loss"])
    assert all(np.isfinite(h["loss_seq"]) and h["loss_seq"] > 0 for h in history)
    assert history[-1]["loss"] < history[0]["loss"]
    assert optimizer.state["count"] == 8
    assert all(p.dtype == torch.float32 for p in model.parameters())
    from s2m2_torch.tools.checkpoint import latest_step
    assert latest_step(str(tmp_path / "ckpt")) == 8


def test_train_logs_and_checkpoints_where_jax_does(tmp_path):
    """Records at every log_every-th step and at the last; checkpoints at
    every checkpoint_every-th step after step 0 and at num_steps."""
    cfg = ModelConfig(feature_channels=16, num_transformer=1, refine_iter=1)
    batches = tdata.synthetic_stereo_batches(batch=1, height=64, width=64,
                                             max_disp=8, seed=1)
    lines = []
    _, _, history = train(cfg, batches, num_steps=5, log_every=3, log=lines.append,
                          checkpoint_dir=str(tmp_path), checkpoint_every=2,
                          device="cpu")
    assert [h["step"] for h in history] == [0, 3, 4] and len(lines) == 3
    assert sorted(os.listdir(tmp_path)) == ["2", "4", "5"]


def test_train_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(ModelConfig(feature_channels=16, num_transformer=1), iter([]))


def test_augmentation_equals_jax():
    """augment_batches and its parts give the JAX module's arrays under the
    same seed (both are numpy)."""
    base = list(jdata.synthetic_stereo_batches(batch=2, height=32, width=48,
                                               max_disp=8, n_batches=4, seed=0))
    got = list(taug.augment_batches(iter(base), seed=5))
    want = list(jaug.augment_batches(iter(base), seed=5))
    for g, w in zip(got, want):
        for k in ("img0", "img1", "gt_disp", "valid"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    img = base[0]["img0"][0]
    for fn in ("photometric_jitter", "eraser_occlusion"):
        np.testing.assert_array_equal(getattr(taug, fn)(img, np.random.default_rng(3)),
                                      getattr(jaug, fn)(img, np.random.default_rng(3)))
    b0 = base[0]
    args = (b0["img0"][0], b0["img1"][0], b0["gt_disp"][0], b0["valid"][0])
    for g, w in zip(taug.augment_sample(*args, np.random.default_rng(0), p_vflip=1.0),
                    jaug.augment_sample(*args, np.random.default_rng(0), p_vflip=1.0)):
        np.testing.assert_array_equal(g, w)


def test_synthetic_batches_equal_jax():
    got = tdata.synthetic_stereo_batches(batch=2, height=32, width=48, max_disp=8,
                                         n_batches=2, seed=4)
    want = jdata.synthetic_stereo_batches(batch=2, height=32, width=48, max_disp=8,
                                          n_batches=2, seed=4)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def _write_pfm(path, data):
    with open(path, "wb") as f:
        f.write(f"Pf\n{data.shape[1]} {data.shape[0]}\n-1.0\n".encode())
        np.flipud(data).astype("<f4").tofile(f)


def _middlebury_tree(root, seed=0):
    """Three seeded scenes of different sizes, each at least the crop,
    disparities with inf and 0 holes; and one directory without GT."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate([(40, 56), (48, 64), (32, 44)]):
        d = root / f"scene{i}"
        d.mkdir()
        for name in ("im0.png", "im1.png"):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(d / name)
        disp = rng.uniform(1, 30, (h, w)).astype(np.float32)
        disp[rng.uniform(size=(h, w)) < 0.1] = np.inf
        disp[rng.uniform(size=(h, w)) < 0.05] = 0.0
        _write_pfm(d / "disp0GT.pfm", disp)
    (root / "no_gt").mkdir()


@pytest.mark.parametrize("loop", [False, True])
def test_directory_batches_equal_jax(tmp_path, loop):
    _middlebury_tree(tmp_path)
    kw = dict(batch=2, crop=(32, 40), seed=3, loop=loop)
    got = tdata.directory_batches(str(tmp_path), **kw)
    want = jdata.directory_batches(str(tmp_path), **kw)
    n = 0
    for g, w in zip(got, want):
        for k in ("img0", "img1", "gt_disp", "valid"):
            assert g[k].dtype == np.float32 and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
        n += 1
        if n == 4:
            break
    assert n == (4 if loop else 1)


def test_directory_batches_without_scenes_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        next(tdata.directory_batches(str(tmp_path)))
