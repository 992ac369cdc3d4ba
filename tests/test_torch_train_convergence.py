"""The port's convergence tool (s2m2_torch/tools/train_convergence.py)
against the JAX script it ports (scripts/train_convergence.py, imported on
the CPU): the same training and held-out data to the bit, the same learning
rate schedule, and the same held-out EPE / bad-2.0 of the seed-0 init; and
the tool's record and checkpoint."""
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2m2_torch.config import ModelConfig
from s2m2_torch.models.init import init_params
from s2m2_torch.tools import train_convergence as tool
from s2m2_torch.tools.convert import load_checkpoint

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, LR = 600, 4e-4


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_convergence", os.path.join(REPO, "scripts", "train_convergence.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("augment", [True, False])
def test_training_batches_equal_the_scripts(script, augment):
    batches = script.synthetic_stereo_batches(batch=2, height=96, width=128, max_disp=16,
                                              seed=0)
    if augment:
        batches = script.augment_batches(batches, seed=1)
    ours = tool.train_batches(2, 96, 128, 16, augment=augment)
    for _ in range(4):
        want, got = next(batches), next(ours)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_held_out_set_equals_the_scripts(script):
    want, got = script.make_eval_set(None), tool.make_eval_set()
    assert len(got) == len(want) == 4
    for w, g in zip(want, got):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_lr_schedule_equals_the_scripts(script, monkeypatch):
    """The optax schedule the script's make_optimizer builds for a 600-step
    run, read at the steps around the warmup's end and later."""
    import optax
    made = []
    real = optax.warmup_cosine_decay_schedule

    def capture(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(optax, "warmup_cosine_decay_schedule", capture)
    script.make_optimizer(lr=LR, warmup_steps=max(STEPS // 20, 1), total_steps=STEPS)
    ours = tool.make_optimizer(STEPS, LR)
    for count in (0, 29, 30, 300, 599):
        want = float(made[0](jnp.int32(count)))
        got = ours.lr_at(count)
        assert abs(got - want) <= 1e-7 * abs(want), (count, got, want)


def test_init_held_out_epe_equals_the_scripts(script):
    """Seed-0 init (bit-identical in both packages): held-out EPE within
    1e-3 px and bad-2.0 within one pixel's share of the script's."""
    from s2m2_torch.models.s2m2 import S2M2
    from s2m2_tpu.models.init import init_params as jax_init
    cfg = script.ModelConfig(feature_channels=32, num_transformer=1, refine_iter=2)
    eval_set = script.make_eval_set(cfg)
    want_epe, want_bad = script.evaluate(jax_init(cfg, seed=0), cfg, eval_set)
    tcfg = ModelConfig(feature_channels=32, num_transformer=1, refine_iter=2)
    model = S2M2(tcfg)
    model.load_state_dict(init_params(tcfg, seed=0))
    got_epe, got_bad = tool.evaluate(model, tool.make_eval_set())
    print(f"held-out EPE at init: port {got_epe}, script {want_epe}; bad-2.0 port "
          f"{got_bad}, script {want_bad}")
    assert abs(got_epe - want_epe) <= 1e-3, (got_epe, want_epe)
    assert abs(got_bad - want_bad) <= 1 / (96 * 128), (got_bad, want_bad)


def test_tool_record_and_checkpoint(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "trained.npz")
    for bf16 in ([], ["--bf16"]):
        assert tool.main(["--steps", "2", "--eval-every", "1", "--device", "cpu",
                          "--save-ckpt", ckpt, *bf16]) == 0
    with open("train_convergence_torch.json") as f:
        record = json.load(f)
    assert set(record) == {"fp32", "bf16"}
    for key, run in record.items():
        assert run["config"]["bf16"] == (key == "bf16") and run["config"]["steps"] == 2
        assert [h["step"] for h in run["history"]] == [0, 1, 2]
        assert run["device"] == "cpu" and run["all_losses_finite"]
        assert run["step_timer"] == "host clock" and run["torch"] == torch.__version__
    with np.load(ckpt) as z, np.load(os.path.join(REPO, "tests", "golden",
                                                  "trained_c32.npz")) as golden:
        assert sorted(z.files) == sorted(golden.files)
        assert all(z[k].shape == golden[k].shape for k in golden.files)
    cfg = ModelConfig(feature_channels=32, num_transformer=1, refine_iter=2)
    state, init = load_checkpoint(ckpt), init_params(cfg, seed=0)
    assert set(state) == set(init)
    assert all(state[k].shape == init[k].shape for k in init)
    with pytest.raises(SystemExit):
        tool.main(["--out", "train_convergence.json", "--device", "cpu"])
    assert "JAX package's record" in capsys.readouterr().err
