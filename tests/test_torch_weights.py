"""s2m2_torch weights: seeded init against the JAX package's, the layout
round trip, and the state-dict key set of the reference CH128NTR1 model."""
import os

import numpy as np
import pytest
import torch

from s2m2_torch.config import ModelConfig, checkpoint_name, get_config
from s2m2_torch.models.init import init_params
from s2m2_torch.models.s2m2 import S2M2
from s2m2_torch.tools.convert import from_jax, load_npz, to_jax, tolerant_merge

torch.set_num_threads(2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("cfg", [ModelConfig(feature_channels=32, num_transformer=1),
                                 ModelConfig(feature_channels=16, num_transformer=2,
                                             num_heads=2)],
                         ids=["c32_ntr1", "c16_ntr2_h2"])
def test_init_matches_jax_bit_for_bit(cfg):
    from s2m2_tpu.config import ModelConfig as JaxConfig
    from s2m2_tpu.models.init import init_params as jax_init
    from s2m2_tpu.tools.convert_checkpoint import flatten

    want = {k: np.asarray(v) for k, v in flatten(jax_init(
        JaxConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}),
        seed=3)).items()}
    got = to_jax(init_params(cfg, seed=3))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jax_layout_round_trip_and_load():
    path = os.path.join(GOLDEN, "s2m2_c32_ntr1.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if not k.startswith("__")}
    sd = from_jax(flat)
    back = to_jax(sd)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    # torch layouts: conv OIHW, transposed conv (I,O,kh,kw), linear (out,in)
    assert tuple(sd["cnn_backbone.conv1_down.0.weight"].shape) == (64, 16, 5, 5)
    assert tuple(sd["upsample_mask_1x.conv_ctx.weight"].shape) == (32, 16, 2, 2)
    assert tuple(sd["feat_pyramid.enc3s.0.self_attn.attn.pe_proj.weight"].shape) == (8, 32)
    model = S2M2(ModelConfig(feature_channels=32, num_transformer=1))
    model.load_state_dict(load_npz(path))  # strict: every key, every shape


def test_state_dict_matches_reference_ch128ntr1():
    cfg = get_config("S")
    assert checkpoint_name(cfg) == "CH128NTR1"
    want = {}
    with open(os.path.join(GOLDEN, "statedict_ch128ntr1.txt")) as f:
        for line in f:
            name, shape = line.split()
            want[name] = tuple(int(s) for s in shape.split(","))
    got = {k: tuple(v.shape) for k, v in S2M2(cfg).state_dict().items()}
    assert got == want


def test_tolerant_merge_skips_mismatched(capsys):
    template = {"a.weight": torch.zeros(2, 3), "b.bias": torch.zeros(4)}
    loaded = {"a.weight": torch.ones(2, 3), "b.bias": torch.ones(5),
              "c.weight": torch.ones(1)}
    merged = tolerant_merge(template, loaded)
    assert torch.equal(merged["a.weight"], torch.ones(2, 3))
    assert torch.equal(merged["b.bias"], torch.zeros(4))
    assert "c.weight" not in merged
    out = capsys.readouterr().out
    assert "Skip loading parameter: b.bias" in out
    assert "Skip unexpected parameter: c.weight" in out
