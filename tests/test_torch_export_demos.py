"""The port's export CLIs end to end on the CPU at a tiny config, as
tests/test_demos.py drives the JAX package's: `python -m
s2m2_torch.demo.export` writes and verifies an artifact (bf16, int8),
and `python -m s2m2_torch.demo.artifact_benchmark` loads and times it."""
import glob
import os
import runpy
import sys

import pytest
import torch

from s2m2_torch import config
from s2m2_torch.config import ModelConfig

torch.set_num_threads(2)


def _run(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module] + argv)
    with pytest.raises(SystemExit) as exc:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    return exc.value.code


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_export_and_artifact_benchmark_demos(tmp_path, monkeypatch, capsys, precision):
    """The export CLI writes one verified artifact named for its padded
    resolution; the benchmark loads only that file (an int8 artifact gets
    seeded weights of its declared shapes) and prints its time."""
    tiny = ModelConfig(feature_channels=16 if precision == "bf16" else 32,
                       num_transformer=1, refine_iter=1)
    monkeypatch.setattr(config, "get_config", lambda *a, **k: tiny)
    out_dir = str(tmp_path / "artifacts")
    assert _run("s2m2_torch.demo.export",
                ["--model_type", "S", "--height", "30", "--width", "64", "--precision",
                 precision, "--out_dir", out_dir, "--verify", "--device", "cpu"],
                monkeypatch) == 0
    arts = glob.glob(os.path.join(out_dir, "*"))
    assert [os.path.basename(a) for a in arts] == \
        [f"s2m2_CH{tiny.feature_channels}NTR1_64x32_{precision}.pt2"]
    assert "verify: disp (1, 32, 64, 1)" in capsys.readouterr().out
    assert _run("s2m2_torch.demo.artifact_benchmark",
                [arts[0], "--iters", "2", "--device", "cpu"], monkeypatch) == 0
    assert "ms/frame" in capsys.readouterr().out
