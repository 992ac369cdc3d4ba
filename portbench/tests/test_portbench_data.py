"""The harness is driven by data, and its yardstick counts what it should."""
import hashlib
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import faults, harness, scenes, trace, weights, yardstick
from portbench.tests.conftest import PORTBENCH, TINY_MODEL, write_root

S = dict(TINY_MODEL, feature_channels=128, refine_iter=3)
ARCH = harness.architecture(PORTBENCH.parent, "s2m2")


def test_files_dropped_into_the_folders_make_a_cell(tmp_path):
    """A configuration, a traffic mix, limits and a new metric reader, added
    as files with no edit of the harness, run as a cell on the CPU."""
    root = write_root(tmp_path, {"conf_median": 1.0, "occ_median": 1.0})
    (root / "portbench" / "metrics" / "calls_in_window.py").write_text(
        "def read(rec):\n    return float(len(rec.calls))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "calls_in_window", "unit": "calls",
                               "workloads": ["tiny.stream"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("tiny.stream", False, root)
    assert cell.shape == (1, 64, 96) and cell.model["feature_channels"] == 32
    assert set(cell.metrics) == {"pairs_per_s", "pairs_per_s.card", "latency_p95_ms", "setup_s",
                                 "calls_in_window"}
    res = harness.run_cell(cell, 2**31 + 11, 1.0, False, device="cpu", log=lambda _: None)
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == {"conf_median", "occ_median"}
    m = res["metrics"]
    assert m["calls_in_window"]["value"] == res["attempted"] >= 2
    assert m["pairs_per_s"]["unit"] == "pairs/s" and m["pairs_per_s"]["value"] > 0
    # a dotted name with no reader of its own reads through its first part's
    assert m["pairs_per_s.card"]["value"] == m["pairs_per_s"]["value"]
    assert res["device"]["platform"] == "cpu"


# A second architecture, dropped into a checkout as files alone: a plain
# reference of one conv and a soft-argmin over a 1D cost volume, and the
# adapter whose program is that reference behind an engine's `run`.
TOY_REFERENCE = '''
import torch
from torch import nn


class Toy(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.channels, self.max_disp = cfg["channels"], cfg["max_disp"]
        self.conv = nn.Conv2d(3, self.channels, 3, padding=1)

    def forward(self, left, right):
        f = self.conv(torch.cat([left, right]).permute(0, 3, 1, 2) / 255.0)
        fl, fr = f.chunk(2)
        cost = torch.einsum("bchw,bchv->bhwv", fl, fr) / self.channels ** 0.5
        x = torch.arange(cost.shape[-1], device=cost.device)
        d = x[:, None] - x[None, :]
        cost = cost.masked_fill((d < 0) | (d >= self.max_disp), float("-inf"))
        return (cost.softmax(-1) * d.clamp(min=0)).sum(-1)
'''
TOY_ARCH = '''
import importlib.util
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

_spec = importlib.util.spec_from_file_location(
    "toy_reference", Path(__file__).resolve().parents[1] / "reference" / "toy.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)


class Engine:
    def __init__(self, cfg, device):
        with torch.device(device):
            self.model = ref.Toy(cfg).eval()
        self.device = device

    @torch.no_grad()
    def run(self, left, right):
        t = time.perf_counter()
        a, b = (torch.from_numpy(np.asarray(x, np.float32)).to(self.device) for x in (left, right))
        disp = self.model(a.reshape(-1, *a.shape[-3:]), b.reshape(-1, *b.shape[-3:]))
        disp = disp.cpu().numpy()
        return disp.reshape(a.shape[:-1]), (time.perf_counter() - t) * 1e3


def build_engine(cell, device, precision=None):
    return Engine(cell.model, device)


def unpack(out):
    disp, ms = out
    return {"disp": disp.reshape(-1, *disp.shape[-2:])}, None, ms


def sane(maps, score, shape):
    return maps["disp"].shape == shape and bool(np.isfinite(maps["disp"]).all())


def reference(cfg):
    return ref.Toy(cfg)


def layout(module):
    return [(name, tuple(p.shape), 27 ** -0.5) for name, p in module.named_parameters()]


@torch.no_grad()
def reference_request(model, left, right, device):
    a, b = (torch.from_numpy(np.asarray(x, np.float32)).to(device) for x in (left, right))
    return model(a, b).cpu().numpy()


def numbers(maps, reference_out):
    return {"disp_max_px": float(np.abs(maps["disp"] - reference_out).max())}


def _disp_plus1():
    run = Engine.run

    def altered(self, left, right):
        disp, ms = run(self, left, right)
        return disp + 1, ms

    return mock.patch.object(Engine, "run", altered)


FAULTS = {"disp_plus1": _disp_plus1}
'''
TOY_MODEL = {"channels": 8, "max_disp": 16}


def write_toy_root(root):
    """A checkout root whose one cell, "tiny.stream", is of the toy
    architecture: only files added to the folders the harness reads."""
    write_root(root, {"disp_max_px": 1e-4})
    pb = root / "portbench"
    (pb / "configs" / "tiny.json").write_text(json.dumps(
        {"architecture": "toy", "model": TOY_MODEL, "precision": "fp32", "weight_gain": 1.0}))
    (pb / "archs" / "toy.py").write_text(TOY_ARCH)
    (pb / "reference").mkdir()
    (pb / "reference" / "toy.py").write_text(TOY_REFERENCE)
    return root


def test_a_second_architecture_is_files_alone(tmp_path):
    """The toy runs as a cell on the CPU, correct; a fault of its FAULTS
    planted in its program is caught; its reference's FLOPs are counted."""
    cell = harness.load_cell("tiny.stream", False, write_toy_root(tmp_path))
    assert cell.arch.__file__ == str(tmp_path / "portbench" / "archs" / "toy.py")
    res = harness.run_cell(cell, 2**31 + 17, 0.5, False, device="cpu", log=lambda _: None)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert res["checks"]["disp_max_px"]["value"] == 0.0
    assert {"pairs_per_s", "latency_p95_ms", "setup_s"} <= set(res["metrics"])
    with faults.plant(cell, "disp_plus1"):
        res = harness.run_cell(cell, 2**31 + 17, 0.5, False, device="cpu", log=lambda _: None)
    assert not res["correct"] and res["failed"] > 0
    assert res["checks"]["disp_max_px"]["value"] == pytest.approx(1.0)
    # FLOPs: the conv over both views, and the correlation of every row
    conv = 2 * (2 * 1) * 8 * 64 * 96 * 3 * 9
    corr = 2 * 1 * 64 * 96 * 96 * 8
    assert yardstick.model_flops(cell.arch.reference, cell.model, 1, 64, 96) == conv + corr
    # no attention kernels: the roofline reads nothing, the mfu reads
    rec = harness.Record(cell, 1.0, 1.0, [harness.Call(10.0, 9.0, 1, False)])
    assert harness.reader(tmp_path, "attn_roofline")(rec) is None
    assert harness.reader(tmp_path, "forward_mfu")(rec) == pytest.approx(
        100 * (conv + corr) / 0.01 / 67e12)


@pytest.mark.parametrize("architecture", [None, "nothing_here"])
def test_a_configuration_must_name_an_architecture_that_has_a_file(tmp_path, architecture):
    root = write_root(tmp_path, {"conf_median": 1.0})
    path = root / "portbench" / "configs" / "tiny.json"
    config = json.loads(path.read_text())
    del config["architecture"]
    if architecture:
        config["architecture"] = architecture
    path.write_text(json.dumps(config))
    with pytest.raises(ValueError if architecture is None else FileNotFoundError,
                       match="portbench/archs"):
        harness.load_cell("tiny.stream", False, root)


def test_a_metric_without_a_workloads_key_is_in_every_cell(tmp_path):
    root = write_root(tmp_path, {"conf_median": 1.0})
    cell = harness.load_cell("tiny.stream", True, root)
    assert {"forward_mfu", "conv_ms_per_pair", "device_idle_share"} <= set(cell.metrics)
    with pytest.raises(KeyError):
        harness.load_cell("tiny.nothing", False, root)


def test_flop_counter_counts_the_reference_at_the_cells_shapes():
    """S at 1216x1024: 3.182 TFLOP. Over the port's own forward on meta
    tensors torch's counter reads 3.023 TFLOP, because there A, B and C are
    custom ops it does not see; their flops by `cost` make up the gap."""
    total = yardstick.model_flops(ARCH.reference, S, 1, 1024, 1216)
    assert total == 3182334181376
    shapes = ARCH.main_path_shapes(S, 1024, 1216)
    own = sum(n * ARCH.cost(k, s, "bfloat16")[1] for k, c in shapes.items()
              for s, n in c.items())
    assert total - own == 3023349088256
    assert yardstick.model_flops(ARCH.reference, S, 2, 1024, 1216) == 2 * total


def test_cost_and_bound_equal_hand_counts():
    # kernel A at S's first scanline shape: (2 views x 256 rows, 304 tokens, 128)
    b, n, d = 512, 304, 128
    assert ARCH.cost("scanline_attention", (b, n, d), "bfloat16") == (
        4 * b * n * d * 2, 4 * b * n * n * d)
    assert ARCH.cost("scanline_cross_attention", (b, n, d), "bfloat16") == (
        8 * b * n * d * 2, 8 * b * n * n * d)
    ms_bytes, ms_ops = ARCH.bound("scanline_attention", (b, n, d), "bfloat16")
    assert ms_bytes == pytest.approx(1e3 * 4 * b * n * d * 2 / 3.35e12)
    assert ms_ops == pytest.approx(1e3 * 4 * b * n * n * d / 989e12)
    # kernel C at S's matcher: one row of 304 per 1/4-res line, 128 channels
    shape = (1, 256, 304, 128)
    nbytes, flops = ARCH.cost("fused_correlation_ot", shape, "bfloat16")
    assert nbytes == (2 * 256 * 304 * 128 + 2 * 256 * 304 * 304) * 2
    assert flops == 2 * 256 * 304 * 304 * 128
    exps = 256 * (6 * (304 * 305 // 2 + 2 * 304 + 1) + 304 * 305 // 2)
    assert ARCH.bound("fused_correlation_ot", shape, "bfloat16")[2] == pytest.approx(
        1e3 * exps / (16 * 132 * 1980e6))


def test_attention_bound_scales_with_the_batch():
    one = ARCH.attention_bound_ms(S, 1024, 1216, 1, "bfloat16")
    assert 0.25 < one < 0.35  # PERF.md's kernel table: A 0.160 + B 0.143 ms
    assert ARCH.attention_bound_ms(S, 1024, 1216, 8, "bfloat16") == pytest.approx(8 * one)


def _config(name):
    return json.loads((PORTBENCH / "configs" / f"{name}.json").read_text())["model"]


def test_the_committed_cells_count_what_they_counted():
    """The FLOPs and attention bounds of S and XL at 1024x1216, batch 1, as
    the harness counted them before the architecture had a file of its own."""
    s, xl = _config("s2m2_S_fp32"), _config("s2m2_XL_fp32")
    assert yardstick.model_flops(ARCH.reference, s, 1, 1024, 1216) == 3182334181376
    assert yardstick.model_flops(ARCH.reference, xl, 1, 1024, 1216) == 31244532973568
    assert ARCH.attention_bound_ms(s, 1024, 1216, 1, "float32") == 0.9778047554923565
    assert ARCH.attention_bound_ms(xl, 1024, 1216, 1, "float32") == 8.414824391867572


@pytest.mark.parametrize("dtype, digest", [
    (torch.bfloat16, "114fc6d2684496b488310bec6ba6ddc1a11c307bd6c3657ee391f8306b2ea415"),
    (torch.float32, "567b4d61cf2331c509729999d52c288f89a31321a81d781315c2bb2383127775")])
def test_weights_are_the_ones_made_before(dtype, digest):
    """The tiny configuration's weights at a fixed seed, to the bit."""
    w = weights.make(ARCH, TINY_MODEL, 2**31 + 5, "cpu", 2 ** 0.5, dtype)
    h = hashlib.sha256()
    for k in sorted(w):
        h.update(k.encode())
        h.update(w[k].float().numpy().tobytes())
    assert len(w) == 660 and h.hexdigest() == digest


def test_families():
    assert yardstick.family("void scanline_attention_kernel<I>(...)") == "attention"
    assert yardstick.family("pytorch_flash::flash_fwd_kernel") == "attention"
    assert yardstick.family("sm90_xmma_fprop_implicit_gemm_bf16") == "convolution"
    assert yardstick.family("Memcpy DtoH (Device -> Pageable)") == "transfer"
    assert yardstick.family("void at::native::vectorized_elementwise_kernel<4>") == "elementwise"
    assert yardstick.family("void at::native::unrolled_elementwise_kernel<copy>") == "copy / layout"
    assert yardstick.family("corr_ot_kernel<bf16>") == "other"


@pytest.mark.parametrize("name, fam", [
    ("void scanline_attention_kernel<I>(...)", "attention"),
    ("pytorch_flash::flash_fwd_kernel", "attention"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "convolution"),
    ("Memcpy DtoH (Device -> Pageable)", "transfer"),
    ("Memset (Device)", "transfer"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("void at::native::unrolled_elementwise_kernel<copy>", "copy / layout"),
    ("void at::native::index_elementwise_kernel<128, 4>", "copy / layout"),
    ("corr_ot_kernel<bf16>", "correlation + Sinkhorn (ours)"),
    ("void (anonymous namespace)::streamed::corr_ot_kernel<float>(Args)",
     "correlation + Sinkhorn (ours)"),
    ("fused_block_kernel<bf16, 3>", "fused block (ours)"),
    ("void (anonymous namespace)::conv_tf32x3_kernel<3, 3>(ConvArgs)", "convolution"),
    ("void (anonymous namespace)::gemm_kernel<Int8Cfg>(Params)", "E int8 GEMM (ours)"),
    ("void pack_rows_kernel<float>(...)", "E int8 pack (ours)"),
    ("int8_attn_fused_kernel", "other"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm>", "matrix product"),
    ("nvjet_tst_128x64", "matrix product"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4>", "softmax"),
    ("void at::native::reduce_kernel<512, 1>", "reduction"),
    ("void cudnn::winograd_nonfused::winogradForwardData4x4", "convolution"),
    ("something_else", "other")])
def test_an_s2m2_cells_families_are_the_ones_it_had(name, fam):
    """S2M2's kernel families, tried before the shared table, class each
    kernel as the single table did before they moved to its file."""
    assert yardstick.family(name, ARCH.FAMILIES + yardstick.FAMILIES) == fam


def test_scenes_are_seeded_shifted_views():
    a = scenes.pool(2**31 + 3, 2, 64, 96, 16, 2.0, "cpu")
    b = scenes.pool(2**31 + 3, 2, 64, 96, 16, 2.0, "cpu")
    c = scenes.pool(2**31 + 4, 2, 64, 96, 16, 2.0, "cpu")
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) for x, y in zip(a, b))
    assert not np.array_equal(a[0][0], c[0][0])
    left, right = a[0]
    assert left.dtype == right.dtype == np.uint8 and left.shape == (64, 96, 3)
    rng = np.random.default_rng(2**31 + 3)
    disp = scenes.disparity(rng, 64, 96, 16)
    xs = np.arange(96)
    inside = xs[None, :] + disp < 96
    shifted = np.take_along_axis(left.astype(np.float64),
                                 np.minimum(xs[None, :] + disp, 95)[..., None].repeat(3, -1),
                                 axis=1)
    # right[x] = left[x + d(x)] wherever x + d stays in the view, plus noise
    assert np.abs(right - shifted)[inside].mean() < 3.0


def test_weights_follow_the_initialisation_and_the_programs_names():
    from s2m2_torch.config import ModelConfig
    from s2m2_torch.models.s2m2 import S2M2
    w = weights.make(ARCH, TINY_MODEL, 2**31 + 5, "cpu", 2.0)
    assert w.keys() == S2M2(ModelConfig(**TINY_MODEL)).state_dict().keys()
    assert all(t.dtype == torch.bfloat16 for t in w.values())
    assert torch.equal(w["cnn_backbone.norm1.weight"], torch.ones(32, dtype=torch.bfloat16))
    assert torch.equal(w["cnn_backbone.norm1.bias"], torch.zeros(32, dtype=torch.bfloat16))
    conv = w["cnn_backbone.conv1_down.0.weight"]           # Conv(16, 64, 5)
    bound = 2.0 / math.sqrt(16 * 25)
    assert conv.shape == (64, 16, 5, 5) and conv.float().abs().max() <= bound * 1.004
    assert conv.float().abs().max() > 0.9 * bound
    convt = w["upsample_mask_4x_refine.conv_x.weight"]     # ConvT(32, 64, 2): fan-in 32 * 4
    assert convt.float().abs().max() <= 2.0 / math.sqrt(32 * 4) * 1.004
    again = weights.make(ARCH, TINY_MODEL, 2**31 + 5, "cpu", 2.0)
    assert all(torch.equal(w[k], again[k]) for k in w)
    # a float32 configuration gets the same draws, unrounded
    w32 = weights.make(ARCH, TINY_MODEL, 2**31 + 5, "cpu", 2.0, torch.float32)
    assert all(t.dtype == torch.float32 for t in w32.values())
    assert torch.equal(w32["cnn_backbone.conv1_down.0.weight"].bfloat16(), conv)


def test_trace_slice_reduces_a_chrome_trace(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.CALL_SPAN, "ts": 100, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": trace.CALL_SPAN, "ts": 210, "dur": 90},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 101, "dur": 30},
        {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 170, "dur": 25},
        {"ph": "X", "cat": "kernel", "name": "sm90_fprop_implicit_gemm", "ts": 110, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "vectorized_elementwise_kernel", "ts": 140, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 185, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "scanline_attention_kernel", "ts": 230, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 400, "dur": 50},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 120},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace.Slice.from_chrome_trace(path, pairs=2)
    assert (s.t0, s.t1, s.calls) == (100, 300, 2)
    assert s.busy == [[110, 160], [185, 195], [230, 280]]
    assert s.busy_s == pytest.approx(110e-6) and s.wall_s == pytest.approx(200e-6)
    assert s.family_ms("convolution") == pytest.approx(0.04)
    assert s.family_ms("elementwise", "copy / layout") == pytest.approx(0.02)
    assert s.gaps() == [(100, 110), (160, 185), (195, 230), (280, 300)]
    b = s.breakdown()
    assert b["device_ops"][0] == ["scanline_attention_kernel", pytest.approx(50e-6)]
    labels = [g[0] for g in b["idle_gaps"]]
    assert labels[0] == "host: run() outside torch ops"            # 195-230
    assert "host: aten::to" in labels and "host: between calls" not in labels[:1]


def test_run_overhead_and_mfu_readers():
    root = Path(__file__).resolve().parents[2]
    cell = harness.Cell("x", 1, {"architecture": "s2m2", "model": S, "precision": "bf16",
                                 "fused_block": False, "weight_gain": 1.0},
                        {"batch": 1, "height": 1024, "width": 1216}, {}, {}, root)
    calls = [harness.Call(100.0, 90.0, 1, False), harness.Call(120.0, 100.0, 1, False),
             harness.Call(500.0, 400.0, 1, True)]
    rec = harness.Record(cell, 10.0, 1.0, calls)
    assert harness.reader(root, "run_overhead_ms")(rec) == pytest.approx(15.0)
    mfu = harness.reader(root, "forward_mfu")(rec)
    assert mfu == pytest.approx(100 * 3182334181376 * 2 / 0.22 / 989e12)
    assert harness.reader(root, "conv_ms_per_pair")(rec) is None
    assert harness.reader(root, "pairs_per_s")(rec) == 3.0
