"""The harness is driven by data, and its yardstick counts what it should."""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, scenes, trace, weights, yardstick
from portbench.tests.conftest import TINY_MODEL, write_root

S = dict(TINY_MODEL, feature_channels=128, refine_iter=3)


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
    total = yardstick.model_flops(S, 1, 1024, 1216)
    assert total == 3182334181376
    shapes = yardstick.main_path_shapes(S, 1024, 1216)
    own = sum(n * yardstick.cost(k, s, "bfloat16")[1] for k, c in shapes.items()
              for s, n in c.items())
    assert total - own == 3023349088256
    assert yardstick.model_flops(S, 2, 1024, 1216) == 2 * total


def test_cost_and_bound_equal_hand_counts():
    # kernel A at S's first scanline shape: (2 views x 256 rows, 304 tokens, 128)
    b, n, d = 512, 304, 128
    assert yardstick.cost("scanline_attention", (b, n, d), "bfloat16") == (
        4 * b * n * d * 2, 4 * b * n * n * d)
    assert yardstick.cost("scanline_cross_attention", (b, n, d), "bfloat16") == (
        8 * b * n * d * 2, 8 * b * n * n * d)
    ms_bytes, ms_ops = yardstick.bound("scanline_attention", (b, n, d), "bfloat16")
    assert ms_bytes == pytest.approx(1e3 * 4 * b * n * d * 2 / 3.35e12)
    assert ms_ops == pytest.approx(1e3 * 4 * b * n * n * d / 989e12)
    # kernel C at S's matcher: one row of 304 per 1/4-res line, 128 channels
    shape = (1, 256, 304, 128)
    nbytes, flops = yardstick.cost("fused_correlation_ot", shape, "bfloat16")
    assert nbytes == (2 * 256 * 304 * 128 + 2 * 256 * 304 * 304) * 2
    assert flops == 2 * 256 * 304 * 304 * 128
    exps = 256 * (6 * (304 * 305 // 2 + 2 * 304 + 1) + 304 * 305 // 2)
    assert yardstick.bound("fused_correlation_ot", shape, "bfloat16")[2] == pytest.approx(
        1e3 * exps / (16 * 132 * 1980e6))


def test_attention_bound_scales_with_the_batch():
    one = yardstick.attention_bound_ms(S, 1024, 1216, 1, "bfloat16")
    assert 0.25 < one < 0.35  # PERF.md's kernel table: A 0.160 + B 0.143 ms
    assert yardstick.attention_bound_ms(S, 1024, 1216, 8, "bfloat16") == pytest.approx(8 * one)


def test_families():
    assert yardstick.family("void scanline_attention_kernel<I>(...)") == "attention"
    assert yardstick.family("pytorch_flash::flash_fwd_kernel") == "attention"
    assert yardstick.family("sm90_xmma_fprop_implicit_gemm_bf16") == "convolution"
    assert yardstick.family("Memcpy DtoH (Device -> Pageable)") == "transfer"
    assert yardstick.family("void at::native::vectorized_elementwise_kernel<4>") == "elementwise"
    assert yardstick.family("void at::native::unrolled_elementwise_kernel<copy>") == "copy / layout"
    assert yardstick.family("corr_ot_kernel<bf16>") == "correlation + Sinkhorn (ours)"


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
    w = weights.make(TINY_MODEL, 2**31 + 5, "cpu", 2.0)
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
    again = weights.make(TINY_MODEL, 2**31 + 5, "cpu", 2.0)
    assert all(torch.equal(w[k], again[k]) for k in w)
    # a float32 configuration gets the same draws, unrounded
    w32 = weights.make(TINY_MODEL, 2**31 + 5, "cpu", 2.0, torch.float32)
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
    cell = harness.Cell("x", 1, {"model": S, "precision": "bf16", "fused_block": False,
                                 "weight_gain": 1.0},
                        {"batch": 1, "height": 1024, "width": 1216}, {}, {}, root)
    calls = [harness.Call(100.0, 90.0, 1, False), harness.Call(120.0, 100.0, 1, False),
             harness.Call(500.0, 400.0, 1, True)]
    rec = harness.Record(cell, 10.0, 1.0, calls)
    assert harness.reader(root, "run_overhead_ms")(rec) == pytest.approx(15.0)
    mfu = harness.reader(root, "forward_mfu")(rec)
    assert mfu == pytest.approx(100 * 3182334181376 * 2 / 0.22 / 989e12)
    assert harness.reader(root, "conv_ms_per_pair")(rec) is None
    assert harness.reader(root, "pairs_per_s")(rec) == 3.0
