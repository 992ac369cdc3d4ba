"""The port's export of calibrated int8 engines on the CPU
(s2m2_torch/tools/export.py `export_quantized_forward`), after
tests/test_export.py's quantized round trip: the static scales baked into
the program, the prequantized weights as its arguments, kernel E's pack and
GEMM as custom ops, the int8r residual stream's int8 tensors traced
through, and the quant context's site count checked while tracing."""
import numpy as np
import pytest
import torch

from s2m2_torch.config import ModelConfig
from s2m2_torch.runtime.engine import StereoEngine
from s2m2_torch.tools import export as ex
from s2m2_torch.utils.image import image_pad

torch.set_num_threads(2)
CFG = ModelConfig(feature_channels=32, num_transformer=1, refine_iter=1)
H, W = 64, 96


def _engine(precision):
    rng = np.random.default_rng(1)
    img0, img1 = (image_pad(rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32))
                  for _ in range(2))
    eng = StereoEngine(CFG, precision=precision, seed=0, device="cpu")
    eng.calibrate(img0, img1)
    return eng, img0, img1


@pytest.mark.parametrize("precision", ["int8", "int8r"])
def test_export_quantized_roundtrip(tmp_path, precision):
    """A calibrated CH32 engine's program reproduces the live engine (1e-4)
    and holds one E pack and GEMM op per launch the live forward logs. An
    uncalibrated engine is refused."""
    from s2m2_torch.models import quant
    eng, img0, img1 = _engine(precision)
    ref = eng.forward_padded(img0, img1)
    log = quant.last_log()
    blob = ex.export_quantized_forward(eng, H, W)
    path = tmp_path / ex.artifact_name(CFG, H, W, precision)
    ex.save_artifact(str(path), blob)
    fn = ex.load_artifact(str(path), device="cpu")
    calls = {str(n.target) for n in fn.program.graph.nodes if n.op == "call_function"}
    assert {"s2m2_torch.int8_quantize_pack.default", "s2m2_torch.int8_gemm.default"} <= calls
    nodes = [str(n.target) for n in fn.program.graph.nodes]
    assert nodes.count("s2m2_torch.int8_quantize_pack.default") == \
        sum(r["kind"] == "pack" for r in log)
    assert nodes.count("s2m2_torch.int8_gemm.default") == sum(r["kind"] == "gemm" for r in log)
    got = fn(ex.quantized_state(eng), torch.from_numpy(img0), torch.from_numpy(img1))
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="calibrated"):
        ex.export_quantized_forward(StereoEngine(CFG, precision=precision, device="cpu"),
                                    H, W)


def test_site_count_is_checked_while_tracing():
    """Scales that do not match the forward's sites fail the export, as
    they fail a live forward (quant.quantized's cursor check)."""
    eng, _, _ = _engine("int8")
    eng.quant_scales = eng.quant_scales[:-1]
    with pytest.raises(ValueError, match="diverged"):
        ex.export_quantized_forward(eng, H, W)
