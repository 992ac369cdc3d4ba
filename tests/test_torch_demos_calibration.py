"""The port's online-calibration and training demo CLIs end to end on the
CPU at their synthesized defaults (a small size, a tiny engine): CEM with
neither cv2 nor PIL importable, the keypoint method on the synthesized calib
XML (it needs cv2) and its refusal without cv2, training with a checkpoint,
and the refused --mesh."""
import os

import numpy as np
import pytest
import torch

from s2m2_torch.config import ModelConfig
from s2m2_torch.demo import _scenes
from s2m2_torch.utils.calib import load_calibration_data
from tests.torch_demos import SIZE, run_cli, tiny_engines

torch.set_num_threads(2)
RESULT_KEYS = ("roll_delta", "pitch_delta", "yaw_delta", "initial_confidence",
               "final_confidence")


def _result(printed):
    lines = printed.splitlines()
    return dict(line.strip().split(": ") for line in lines[lines.index("result:") + 1:]
                if line.startswith("  "))


def test_online_calibration_cem_defaults(monkeypatch, capsys):
    requests = tiny_engines(monkeypatch)
    assert run_cli("online_calibration", ["--device", "cpu"], monkeypatch) == 0
    result = _result(capsys.readouterr().out)
    assert tuple(result) == RESULT_KEYS
    assert all(np.isfinite(float(v)) for v in result.values())
    assert requests[0][0] == "S" and requests[0][1]["precision"] == "bf16"


def test_online_calibration_kp_on_synthesized_xml(monkeypatch, capsys):
    pytest.importorskip("cv2")
    monkeypatch.setattr(_scenes, "SIZE", SIZE)
    assert run_cli("online_calibration", ["--method", "kp"], monkeypatch, block=()) == 0
    result = _result(capsys.readouterr().out)
    assert tuple(result) == RESULT_KEYS[:3]
    assert all(np.isfinite(float(v)) for v in result.values())


def test_online_calibration_kp_needs_cv2(monkeypatch, capsys):
    assert run_cli("online_calibration", ["--method", "kp"], monkeypatch) != 0
    assert "cv2" in capsys.readouterr().err


def test_synthesized_sensor_xml_reads_back(tmp_path, monkeypatch):
    monkeypatch.setattr(_scenes, "SIZE", SIZE)
    files = _scenes.write_defaults("calibration", str(tmp_path))
    got = load_calibration_data(files["calib.xml"])
    want = _scenes.synthetic_calibration(SIZE[1], SIZE[0])
    for cam in ("left", "right"):
        for k in ("fx", "fy", "cx", "cy"):
            assert got[cam][k] == want[cam][k]
        np.testing.assert_array_equal(got[cam]["distortion"], want[cam]["distortion"])
    for k in ("rotation", "translation"):
        np.testing.assert_array_equal(got["stereo_extrinsic"][k], want["stereo_extrinsic"][k])


def test_synthetic_calibration_default_is_1216x1024():
    calib = _scenes.synthetic_calibration()
    assert (calib["left"]["fx"], calib["left"]["cx"], calib["left"]["cy"]) == \
        (1000.0, 611.3, 509.2)
    assert (calib["right"]["fx"], calib["right"]["cx"], calib["right"]["cy"]) == \
        (1001.5, 604.8, 514.6)


def test_train_demo_defaults(tmp_path, monkeypatch, capsys):
    import s2m2_torch.train.trainer as trainer
    seen = {}
    real = trainer.train

    def spy(cfg, batches, **kwargs):
        seen["cfg"] = cfg
        return real(cfg, batches, **kwargs)

    monkeypatch.setattr(trainer, "train", spy)
    ckpt = tmp_path / "ckpt"
    assert run_cli("train_demo", ["--steps", "2", "--batch", "1", "--height", "64",
                                  "--width", "96", "--checkpoint_dir", str(ckpt),
                                  "--device", "cpu"], monkeypatch) == 0
    assert seen["cfg"] == ModelConfig(feature_channels=32, num_transformer=1, refine_iter=1)
    losses = [float(line.split("loss=")[1].split()[0])
              for line in capsys.readouterr().out.splitlines() if "loss=" in line]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert os.path.isdir(ckpt / "2")


def test_train_demo_refuses_mesh(monkeypatch, capsys):
    """A mesh whose bands the crop cannot hold (here 2x4 with 96 rows: 3
    blocks of 32 for 4 bands) and a mesh spec that is not DATAxBAND are
    refused before any rank starts. Band-sharded training itself runs
    (tests/test_torch_band_train.py)."""
    assert run_cli("train_demo", ["--mesh", "2x4", "--height", "96", "--device", "cpu"],
                   monkeypatch) == 2
    assert "fewer than the 4 bands" in capsys.readouterr().err
    assert run_cli("train_demo", ["--mesh", "2by4", "--device", "cpu"], monkeypatch) == 2
    assert "--mesh takes DATAxBAND" in capsys.readouterr().err
