"""The port's export (s2m2_torch/tools/export.py) on the CPU, after
tests/test_export.py: .pt2 round trips against the port's live forward and
the JAX `forward`, the kernels' custom ops in the graph (one call per
kernel launch of an eager forward, no plain version inlined), and loading
without the model's source. The weight-free programs:
tests/test_torch_export_weightfree.py; the calibrated-int8 ones:
tests/test_torch_export_int8.py."""
import os
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2m2_torch.config import ModelConfig
from s2m2_torch.models.s2m2 import S2M2
from s2m2_torch.ops import flash_attention as fa
from s2m2_torch.ops import fused_block as fb
from s2m2_torch.ops import sinkhorn
from s2m2_torch.tools import export as ex
from s2m2_torch.tools.convert import from_jax

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ModelConfig(feature_channels=16, num_transformer=1, refine_iter=1)
H, W = 64, 96
KERNEL_OPS = ("scanline_attention", "scanline_cross_attention_packed",
              "fused_correlation_ot", "fused_basic_attn_block")


@pytest.fixture(scope="module")
def weights():
    """The JAX package's seed-0 CH16 weights, and the same converted to a
    torch state dict (tools/convert.py)."""
    from s2m2_tpu.config import ModelConfig as JaxConfig
    from s2m2_tpu.models.init import init_params
    from s2m2_tpu.tools.convert_checkpoint import flatten
    params = init_params(JaxConfig(feature_channels=16, num_transformer=1, refine_iter=1),
                         seed=0)
    return params, from_jax({k: np.asarray(v) for k, v in flatten(params).items()})


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return tuple(rng.uniform(0, 255, (1, H, W, 3)).astype(np.float32) for _ in range(2))


def _live(state, images, fused_block=False):
    model = S2M2(CFG, fused_block=fused_block)
    model.load_state_dict(state)
    with torch.inference_mode():
        return model.eval()(*(torch.from_numpy(i) for i in images))


def _op_calls(program):
    """{kernel op: calls} in an exported program's graph."""
    calls = Counter(str(n.target).split(".")[1] for n in program.graph.nodes
                    if n.op == "call_function" and str(n.target).startswith("s2m2_torch."))
    return dict(calls)


def _eager_calls(state, images, monkeypatch, fused_block):
    """{kernel: wrapper calls} of one eager forward."""
    from s2m2_torch.models import matching
    calls = Counter()

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    for mod, name in ((fa, "scanline_attention"), (fa, "scanline_cross_attention_packed"),
                      (fb, "fused_basic_attn_block")):
        monkeypatch.setattr(mod, name, counted(name, getattr(mod, name)))
    monkeypatch.setattr(matching, "fused_correlation_ot",
                        counted("fused_correlation_ot", matching.fused_correlation_ot))
    _live(state, images, fused_block)
    monkeypatch.undo()
    return dict(calls)


@pytest.fixture(scope="module")
def fp32_artifact(weights, tmp_path_factory):
    path = tmp_path_factory.mktemp("art") / ex.artifact_name(CFG, H, W, "fp32")
    ex.save_artifact(str(path), ex.export_forward(weights[1], CFG, H, W,
                                                  compute_dtype=torch.float32, device="cpu"))
    return path


def test_export_roundtrip(weights, images, fp32_artifact):
    """The fp32 artifact against the port's live forward (1e-5) and the JAX
    forward on the same seeded weights (1e-4, tests/test_export.py:27)."""
    from s2m2_tpu.config import ModelConfig as JaxConfig
    from s2m2_tpu.models.s2m2 import forward
    assert fp32_artifact.name == "s2m2_CH16NTR1_96x64_fp32.pt2"
    assert fp32_artifact.stat().st_size > 1000
    fn = ex.load_artifact(str(fp32_artifact), device="cpu")
    disp, occ, conf = fn(*(torch.from_numpy(i) for i in images))
    assert disp.shape == (1, H, W, 1) and disp.dtype == torch.float32
    for got, want in zip((disp, occ, conf), _live(weights[1], images)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    jcfg = JaxConfig(feature_channels=16, num_transformer=1, refine_iter=1)
    ref = jax.jit(lambda p, a, b: forward(p, a, b, jcfg))(
        weights[0], jnp.asarray(images[0]), jnp.asarray(images[1]))
    np.testing.assert_allclose(disp.numpy(), np.asarray(ref[0]), atol=1e-4)


def test_graph_holds_one_custom_op_per_kernel_launch(weights, images, fp32_artifact,
                                                     monkeypatch):
    """The program calls A, B and C's ops as often as an eager forward calls
    their wrappers (test_program_text shows tracing inlines no plain
    version)."""
    program = ex.load_artifact(str(fp32_artifact), device="cpu").program
    eager = _eager_calls(weights[1], images, monkeypatch, fused_block=False)
    assert eager["scanline_attention"] > 0 and eager["fused_correlation_ot"] == 1
    assert _op_calls(program) == eager


def test_fused_block_export(weights, images, monkeypatch, tmp_path):
    """fused_block=True: the scanline blocks are fused_basic_attn_block calls
    (as many as the eager forward's), and the program equals the live
    fused forward."""
    blob = ex.export_forward(weights[1], CFG, H, W, compute_dtype=torch.float32,
                             device="cpu", fused_block=True)
    path = tmp_path / "fused.pt2"
    ex.save_artifact(str(path), blob)
    fn = ex.load_artifact(str(path), device="cpu")
    calls = _op_calls(fn.program)
    eager = _eager_calls(weights[1], images, monkeypatch, fused_block=True)
    assert calls["fused_basic_attn_block"] > 0 and calls == eager
    got = fn(*(torch.from_numpy(i) for i in images))
    for g, w in zip(got, _live(weights[1], images, fused_block=True)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_program_text(weights, monkeypatch):
    """The readable program: the static entry shape and the kernels' ops.
    The plain versions raise while it is traced, so none is inlined."""
    def inlined(*args, **kwargs):
        raise AssertionError("a plain version was traced into the program")

    for mod, name in ((fa, "scanline_attention_plain"), (fa, "packed_cross_attention_plain"),
                      (sinkhorn, "fused_correlation_ot_plain")):
        monkeypatch.setattr(mod, name, inlined)
    text = ex.export_program_text(weights[1], CFG, 32, 64, compute_dtype=torch.float32,
                                  device="cpu")
    assert "[1, 32, 64, 3]" in text
    for name in KERNEL_OPS[:3]:
        assert f"torch.ops.s2m2_torch.{name}.default" in text


def test_load_without_model_source(fp32_artifact):
    """A fresh process loads and runs the artifact importing only
    s2m2_torch.tools.export: no jax, s2m2_tpu or s2m2_torch.models."""
    code = (
        "import sys, torch\n"
        "from s2m2_torch.tools.export import load_artifact\n"
        f"fn = load_artifact({str(fp32_artifact)!r}, device='cpu')\n"
        f"d = fn(torch.zeros(1, {H}, {W}, 3), torch.zeros(1, {H}, {W}, 3))[0]\n"
        f"assert d.shape == (1, {H}, {W}, 1)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 's2m2_tpu',"
        " 's2m2_torch.models'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_load_on_the_card_raises_without_one(fp32_artifact):
    if torch.cuda.is_available():
        pytest.skip("a card is present: loading on it is the default")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ex.load_artifact(str(fp32_artifact))
