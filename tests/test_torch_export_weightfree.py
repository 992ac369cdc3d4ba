"""The port's weight-free export on the CPU
(s2m2_torch/tools/export.py `export_forward_with_weights`), after
tests/test_export.py: the program takes the state dict as an argument and
holds none of it; XL at 1024x1216 traced on the meta device stays small."""
import numpy as np
import torch

from s2m2_torch.config import ModelConfig, get_config
from s2m2_torch.models.init import init_params
from s2m2_torch.models.s2m2 import S2M2
from s2m2_torch.tools import export as ex

torch.set_num_threads(2)
CFG = ModelConfig(feature_channels=16, num_transformer=1, refine_iter=1)
H, W = 64, 96


def test_export_with_weights_roundtrip(tmp_path):
    """The weight-free program takes the state dict as its first argument
    and holds no tensor of it: its only constants are the positional
    encoding's tables, which the forward builds from the shapes."""
    blob = ex.export_forward_with_weights(CFG, H, W, compute_dtype=torch.float32,
                                          device="cpu")
    path = tmp_path / "weightfree.pt2"
    ex.save_artifact(str(path), blob)
    fn = ex.load_artifact(str(path), device="cpu")
    assert not fn.program.state_dict
    assert sum(t.numel() for t in fn.program.constants.values()) < 4096
    state = init_params(CFG, seed=0)
    rng = np.random.default_rng(0)
    img0, img1 = (torch.from_numpy(rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32))
                  for _ in range(2))
    got = fn(state, img0, img1)
    model = S2M2(CFG)
    model.load_state_dict(state)
    with torch.inference_mode():
        want = model.eval()(img0, img1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_export_with_weights_scales_to_xl():
    """XL at 1024x1216, traced weight-free on the meta device: program text
    only (its bf16 weights would be 812 MB)."""
    blob = ex.export_forward_with_weights(get_config("XL"), 1024, 1216, device="meta")
    assert len(blob) < 64 * 1024 * 1024, len(blob)
