"""An exported int8 program (s2m2_torch/tools/export.py) of an engine with
the int8_attn opt-in holds kernel F as the custom op
`s2m2_torch::int8_attention`, one per attention core the live forward
runs, and reproduces the live engine."""
import numpy as np
import torch

from s2m2_torch.models import quant
from s2m2_torch.runtime.engine import StereoEngine

torch.set_num_threads(2)


def test_export_int8_attn_program_holds_kernel_f(tmp_path):
    """A calibrated int8 engine with int8_attn exports to a program with one
    `s2m2_torch::int8_attention` op per core the live forward runs, and the
    program reproduces the live engine within 1e-4."""
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.tools import export as ex
    from s2m2_torch.utils.image import image_pad
    cfg = ModelConfig(feature_channels=32, num_transformer=1, refine_iter=1)
    rng = np.random.default_rng(1)
    img0, img1 = (image_pad(rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32))
                  for _ in range(2))
    eng = StereoEngine(cfg, precision="int8", seed=0, device="cpu", int8_attn=True)
    eng.calibrate(img0, img1)
    ref = eng.forward_padded(img0, img1)
    cores = sum(r["kind"] == "attention" for r in quant.last_log())
    path = tmp_path / "int8_attn.pt2"
    ex.save_artifact(str(path), ex.export_quantized_forward(eng, 64, 96))
    fn = ex.load_artifact(str(path), device="cpu")
    nodes = [str(n.target) for n in fn.program.graph.nodes]
    assert cores > 0 and nodes.count("s2m2_torch.int8_attention.default") == cores
    got = fn(ex.quantized_state(eng), torch.from_numpy(img0), torch.from_numpy(img1))
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4)
