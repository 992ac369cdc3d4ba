"""Training checkpoints (s2m2_torch/tools/checkpoint.py): the orbax
layout of s2m2_tpu/tools/checkpoint.py with torch.save, kept steps, and a
resumed step equal to an uninterrupted one."""
import json
import os

import numpy as np
import pytest
import torch

from s2m2_torch.config import ModelConfig
from s2m2_torch.models.init import init_params
from s2m2_torch.models.s2m2 import S2M2
from s2m2_torch.tools import checkpoint as ck
from s2m2_torch.train import step as tstep
from s2m2_torch.train.data import synthetic_stereo_batches

torch.set_num_threads(2)
CFG = ModelConfig(feature_channels=16, num_transformer=1, refine_iter=1)


def test_round_trip_and_layout(tmp_path):
    rng = np.random.default_rng(0)
    params = {"a.weight": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
              "b.bias": torch.arange(5, dtype=torch.float32)}
    opt_state = {"count": 7, "mu": {k: v * 2 for k, v in params.items()},
                 "nu": {k: v * 3 for k, v in params.items()}}
    assert ck.save_checkpoint(tmp_path, 3, params, opt_state, meta={"step": 3}) == 3
    assert sorted(os.listdir(tmp_path / "3")) == ["meta.json", "opt_state.pt", "params.pt"]
    assert json.loads((tmp_path / "3" / "meta.json").read_text()) == {"step": 3}
    p, o, m = ck.restore_checkpoint(tmp_path, with_opt_state=True, with_meta=True)
    assert m == {"step": 3} and o["count"] == 7
    for k in params:
        assert torch.equal(p[k], params[k])
        assert torch.equal(o["mu"][k], opt_state["mu"][k])
        assert torch.equal(o["nu"][k], opt_state["nu"][k])
    assert set(ck.restore_checkpoint(tmp_path, 3)) == set(params)
    ck.save_checkpoint(tmp_path, 4, params)  # params only
    assert sorted(os.listdir(tmp_path / "4")) == ["params.pt"]
    with pytest.raises(FileExistsError):
        ck.save_checkpoint(tmp_path, 4, params)
    assert not [n for n in os.listdir(tmp_path) if "tmp" in n]


def test_latest_step_and_missing(tmp_path):
    assert ck.latest_step(tmp_path / "absent") is None
    assert ck.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(tmp_path)
    (tmp_path / "7.tmp-123").mkdir()  # an unfinished write is not a step
    (tmp_path / "notes").mkdir()
    assert ck.latest_step(tmp_path) is None
    ck.save_checkpoint(tmp_path, 2, {"x": torch.zeros(1)})
    assert ck.latest_step(tmp_path) == 2
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(tmp_path, step=5)


def test_max_to_keep(tmp_path):
    for step in (1, 2, 10, 3, 20):
        ck.save_checkpoint(tmp_path, step, {"x": torch.full((1,), float(step))})
    assert sorted(int(n) for n in os.listdir(tmp_path)) == [3, 10, 20]
    assert ck.latest_step(tmp_path) == 20
    assert float(ck.restore_checkpoint(tmp_path)["x"]) == 20.0
    for step in (21, 22):
        ck.save_checkpoint(tmp_path, step, {"x": torch.zeros(1)}, max_to_keep=1)
    assert os.listdir(tmp_path) == ["22"]


def _fresh(lr=1e-3):
    model = S2M2(CFG)
    model.load_state_dict(init_params(CFG, seed=0))
    opt = tstep.make_optimizer(lr=lr, warmup_steps=1, total_steps=6)
    return model, opt, tstep.make_train_step(CFG, model, opt)


def test_resumed_step_equals_uninterrupted(tmp_path):
    """Three steps, a checkpoint, two more steps; against a model and
    optimizer restored from the checkpoint taking the same two steps: the
    parameters and optimizer state are bitwise equal."""
    batches = list(synthetic_stereo_batches(batch=1, height=64, width=64, max_disp=8,
                                            n_batches=5, seed=2))
    model, opt, step = _fresh()
    for b in batches[:3]:
        step(b)
    ck.save_checkpoint(tmp_path, 3, model.state_dict(), opt.state_dict(),
                       meta={"step": 3})
    for b in batches[3:]:
        step(b)

    model2, opt2, _ = _fresh()
    params, opt_state, meta = ck.restore_checkpoint(tmp_path, with_opt_state=True,
                                                    with_meta=True)
    assert meta["step"] == 3
    model2.load_state_dict(params)
    opt2.init(dict(model2.named_parameters()))
    opt2.load_state_dict(opt_state)
    step2 = tstep.make_train_step(CFG, model2, opt2)
    for b in batches[3:]:
        step2(b)
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k
    assert opt2.state["count"] == opt.state["count"] == 5
    for key in ("mu", "nu"):
        for k, v in opt.state[key].items():
            assert torch.equal(opt2.state[key][k], v), (key, k)
