"""Band-sharded training of the port (s2m2_torch/train/step.py over a mesh
with n_band > 1) on gloo ranks of the CPU: 1x2 (bands of 64 + 32 rows),
2x2 (a pair a data rank, 64 + 32) and 1x3 (32 + 32 + 32) steps of the
`TRAIN` config on one 96x96 batch whose pairs have different valid masks,
against one process with the same batch:

- loss within 1e-6 relative;
- the whole gradient within 1e-6 relative L2, and each leaf within 1e-6 of
  the whole gradient's norm (the data-parallel test's rule,
  tests/test_torch_parallel_train.py: the attention blocks' q/k leaves are
  sums that cancel, and float32 moves them by about 1e-3 of themselves
  when the sums are split);
- the parameters after the AdamW step within 1e-6 wherever the one-process
  gradient is at least 1e-6 in magnitude. Below that the first Adam step,
  lr g / (|g| + 1e-8), turns the rounding of such a gradient (about 1% of
  it, measured) into up to 1.3e-5 of the parameter; those elements are
  held by the gradient's bounds above;
- the collectives of the step's forward and backward on every rank equal
  the counts worked out from the config (`band.expected_counts(cfg,
  backward=True)`).

Then `train()` over 3 steps on 1x2 gives the one process's losses, and the
train demo trains with --mesh 1x2."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_parallel_ranks import REPO, run

torch.set_num_threads(2)
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x3": (1, 3)}
SHARDS = {"1x2": [(2, 64), (2, 32)], "2x2": [(1, 64), (1, 32), (1, 64), (1, 32)],
          "1x3": [(2, 32)] * 3}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """{mesh: each rank's result}; 1x2 also runs `train()` for 3 steps."""
    out = {}
    for name, shape in MESHES.items():
        n = 3 if name == "1x2" else 0
        out[name] = run("train_band", shape[0] * shape[1], tmp_path_factory.mktemp(name),
                        timeout=300, mesh=list(shape), steps=n)
    return out


def _norm(grads):
    return np.sqrt(sum(np.linalg.norm(g) ** 2 for g in grads.values()))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_band_sharded_step_matches_one_process(steps, mesh):
    single = steps[mesh][0]["single"]
    norm = _norm(single["grads"])
    for rank, res in enumerate(steps[mesh]):
        got = res["band"]
        assert got["shard"][:2] == SHARDS[mesh][rank], (rank, got["shard"])
        for key, want in single["metrics"].items():
            assert abs(got["metrics"][key] - want) <= 1e-6 * abs(want), (rank, key)
        err = np.sqrt(sum(np.linalg.norm(got["grads"][k] - g) ** 2
                          for k, g in single["grads"].items()))
        assert err <= 1e-6 * norm, (rank, err / norm)
        for k, g in single["grads"].items():
            assert np.linalg.norm(got["grads"][k] - g) <= 1e-6 * norm, (rank, k)
            sure = np.abs(g) >= 1e-6
            diff = np.abs(got["params"][k] - single["params"][k])[sure]
            assert diff.size == 0 or diff.max() <= 1e-6, (rank, k, diff.max())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_band_sharded_step_collectives(steps, mesh):
    for rank, res in enumerate(steps[mesh]):
        assert res["band"]["counts"] == res["expected"], (rank, res["band"]["counts"])
        assert res["expected"] == {"halo": 201, "all_reduce": 9, "all_gather": 5}


def test_band_sharded_trainer_losses(steps):
    want = steps["1x2"][0]["single_losses"]
    for res in steps["1x2"]:
        assert len(res["losses"]) == len(want) == 3
        np.testing.assert_allclose(res["losses"], want, rtol=1e-6)


def test_train_demo_band_mesh():
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    ok = subprocess.run([sys.executable, "-m", "s2m2_torch.demo.train_demo", "--mesh", "1x2",
                         "--steps", "2", "--height", "64", "--width", "64", "--device", "cpu"],
                        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert ok.returncode == 0, ok.stderr[-3000:]
    losses = [float(line.split("loss=")[1].split()[0])
              for line in ok.stdout.splitlines() if "loss=" in line]
    assert len(losses) == 2 and np.isfinite(losses).all(), ok.stdout
