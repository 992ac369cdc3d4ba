"""Data-parallel training of the port (s2m2_torch/train/step.py with a
mesh) on a 2x1 gloo mesh of the CPU: one pair per rank, the two pairs with
different valid masks, so their counts of supervised pixels differ and a
mean of per-rank losses would be wrong.

- Against one process that takes both pairs one at a time and adds their
  gradients (the same reductions: the ranks' losses are normalised by the
  whole batch's counts and their gradients summed): loss 1e-6 relative,
  each gradient leaf 1e-6 relative L2, parameters after the AdamW step
  1e-6.
- Against one process with both pairs in one batch: loss 1e-6 relative and
  the whole gradient 1e-6 relative L2; each leaf within 1e-6 of the whole
  gradient's norm. A leaf's own relative error is not bounded at 1e-6: the
  q/k weights of the attention blocks get gradients near 1e-6 from sums
  that cancel, and their float32 rounding moves them by up to 1.3e-3 of
  themselves when the batch is split, as much as between two thread counts
  of the same single-process step (1.0e-3).
- The loss against the JAX package's loss on the same batch and weights,
  1e-5 relative; `train()` on the mesh gives the single process's losses.
- A band-sharded step refuses a height that does not split into whole
  32-row blocks per band (band-sharded training itself:
  tests/test_torch_band_train.py); the train demo runs with --mesh 2x1 and
  refuses --mesh 1x2 with such a crop."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2m2_torch.config import ModelConfig
from s2m2_torch.models.init import init_params
from s2m2_torch.models.s2m2 import S2M2
from s2m2_torch.parallel.mesh import Mesh
from s2m2_torch.train import step as tstep
from s2m2_torch.train.loss import valid_counts
from s2m2_torch.train.trainer import train

from tests.torch_parallel_ranks import REPO, TRAIN, run, train_batch

torch.set_num_threads(2)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    return run("train_dp", 2, tmp_path_factory.mktemp("dp"))


@pytest.fixture(scope="module")
def accumulated():
    """One process, one thread: each pair's loss normalised by the whole
    batch's counts, gradients added, one AdamW step."""
    torch.set_num_threads(1)
    try:
        cfg = ModelConfig(**TRAIN)
        model = S2M2(cfg)
        model.load_state_dict(init_params(cfg, seed=0))
        params = dict(model.named_parameters())
        full = tstep.as_batch(train_batch(), "cpu")
        counts = valid_counts(full["valid"])
        loss_fn = tstep.make_loss_fn(model)
        loss, grads = 0.0, None
        for i in range(2):
            total, _ = loss_fn(params, {k: v[i:i + 1] for k, v in full.items()}, counts)
            g = torch.autograd.grad(total, list(params.values()))
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            loss += float(total.detach())
        grads = dict(zip(params, grads))
        opt = tstep.make_optimizer(lr=1e-3)
        opt.init(params)
        opt.update(params, grads)
        return {"loss": loss, "grads": {k: g.numpy() for k, g in grads.items()},
                "params": {k: p.detach().numpy() for k, p in params.items()}}
    finally:
        torch.set_num_threads(2)


def test_data_parallel_equals_accumulated_pairs(dp, accumulated):
    for rank, res in enumerate(dp):
        got = res["dp"]
        assert abs(got["metrics"]["loss"] - accumulated["loss"]) <= 1e-6 * accumulated["loss"]
        for k, g in accumulated["grads"].items():
            assert _rel(got["grads"][k], g) <= 1e-6, (rank, k)
        for k, p in accumulated["params"].items():
            assert np.abs(got["params"][k] - p).max() <= 1e-6, (rank, k)


def test_data_parallel_equals_one_batch(dp):
    single = dp[0]["single"]
    norm = np.sqrt(sum(np.linalg.norm(g) ** 2 for g in single["grads"].values()))
    for rank, res in enumerate(dp):
        got = res["dp"]
        for key, want in single["metrics"].items():
            assert abs(got["metrics"][key] - want) <= 1e-6 * abs(want), (rank, key)
        err = np.sqrt(sum(np.linalg.norm(got["grads"][k] - g) ** 2
                          for k, g in single["grads"].items()))
        assert err <= 1e-6 * norm, (rank, err / norm)
        for k, g in single["grads"].items():
            assert np.linalg.norm(got["grads"][k] - g) <= 1e-6 * norm, (rank, k)


def test_data_parallel_trainer_losses(dp):
    want = dp[0]["single_losses"]
    for res in dp:
        assert len(res["dp_losses"]) == len(want) == 2
        np.testing.assert_allclose(res["dp_losses"], want, rtol=1e-6)


def test_data_parallel_loss_matches_jax(dp):
    from s2m2_tpu.config import ModelConfig as JaxConfig
    from s2m2_tpu.models.init import init_params as jax_init
    from s2m2_tpu.models.s2m2 import forward
    from s2m2_tpu.train.loss import sequence_loss
    cfg = JaxConfig(**TRAIN)
    batch = {k: jnp.asarray(v) for k, v in train_batch().items()}

    def loss(params):
        disp, occ, conf, aux = forward(params, batch["img0"], batch["img1"], cfg,
                                       return_aux=True)
        return sequence_loss(aux["disp_seq"], disp, occ, conf, batch["gt_disp"],
                             batch["valid"])[0]

    want = float(jax.jit(loss)(jax_init(cfg, seed=0)))
    for res in dp:
        assert abs(res["dp"]["metrics"]["loss"] - want) <= 1e-5 * want


def test_band_sharded_training_raises():
    """A batch of 48 rows does not split into whole 32-row blocks on 2 bands:
    the step and the trainer raise before any collective."""
    cfg = ModelConfig(**TRAIN)
    mesh = Mesh(1, 2, 0, 0, torch.device("cpu"), "gloo")
    batch = train_batch(h=48)
    step = tstep.make_train_step(cfg, S2M2(cfg), tstep.make_optimizer(), mesh=mesh)
    with pytest.raises(ValueError, match="not a multiple of 32"):
        step(batch)
    with pytest.raises(ValueError, match="not a multiple of 32"):
        train(cfg, iter([batch]), device="cpu", mesh=mesh)


def _demo(*args):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "s2m2_torch.demo.train_demo", *args,
                           "--device", "cpu"], capture_output=True, text=True, timeout=120,
                          env=env, cwd=REPO)


def test_train_demo_mesh():
    ok = _demo("--mesh", "2x1", "--steps", "2", "--height", "64", "--width", "64")
    assert ok.returncode == 0, ok.stderr[-3000:]
    losses = [float(line.split("loss=")[1].split()[0])
              for line in ok.stdout.splitlines() if "loss=" in line]
    assert len(losses) == 2 and np.isfinite(losses).all(), ok.stdout
    refused = _demo("--mesh", "1x2", "--steps", "1", "--height", "80")
    assert refused.returncode != 0
    assert "height 80 is not a multiple of 32" in refused.stderr
