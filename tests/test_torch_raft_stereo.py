"""RAFT-Stereo in the port (s2m2_torch/models/raft_stereo.py) on the CPU:
against the benchmark's plain reference (portbench/reference/raft_stereo.py)
at the published widths, the n-level correlation lookup against
F.grid_sample, the zero-padded convex upsampling, the engine's entry and
refusals, the parameter names, and its spans and counters."""
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import harness, scenes, weights
from portbench.reference import model as s2m2_ref
from portbench.reference import raft_stereo as ref
from s2m2_torch.config import RaftStereoConfig
from s2m2_torch.models import cost_volume as cv
from s2m2_torch.models import raft_stereo
from s2m2_torch.runtime import trace
from s2m2_torch.runtime.engine import StereoEngine

ROOT = Path(__file__).resolve().parents[1]
ARCH = harness.architecture(ROOT, "raft_stereo")
CFG = json.loads((ROOT / "portbench" / "configs" / "raft_stereo_fp32.json").read_text())["model"]
SEED = 2**31 + 5
H, W = 64, 96


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def pair(seed=SEED + 1, h=H, w=W):
    return scenes.pool(seed, 1, h, w, 16, 2.0, "cpu")[0]


def program_and_reference(iters):
    """The engine and the reference of the published configuration with
    `iters` iterations, on the benchmark's weights at SEED (gain sqrt(2))."""
    cfg = dict(CFG, iters=iters)
    w = weights.make(ARCH, cfg, SEED, "cpu", 2 ** 0.5, torch.float32)
    eng = ARCH.build_engine(SimpleNamespace(model=cfg, config={"precision": "fp32"}), "cpu")
    harness.set_weights(eng, w)
    model = ARCH.reference(cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w[name])
    return eng, model


# Measured on this pair: median 4.8e-7 px and 99th percentile 2.9e-6 px at 4
# iterations, 3.8e-6 and 2.3e-5 px at 32. Both sides run the same float32
# convs on the CPU; they part only where the program computes the
# correlation by a matrix product (the reference by einsum) and samples the
# pyramid at x itself (the reference's grid_sample at x normalised to
# [-1, 1] and back, which moves x by its last bits), and the iterations
# carry that on. The reference on TF32 operands misses by 1.4e-3 / 3.5e-3 px
# at 4 iterations and 5.2e-3 / 1.8e-2 px at 32, 4x and more above these
# bounds, which leave the program 50x of room.
MEDIAN_PX, P99_PX = 2e-4, 8e-4


@pytest.mark.parametrize("iters", [4, 32])
def test_program_matches_the_reference_at_published_widths(iters):
    eng, model = program_and_reference(iters)
    left, right = pair()
    disp, occ, conf, score, _ = eng.run(left, right)
    want = ARCH.reference_request(model, left[None], right[None], "cpu")
    nums = ARCH.numbers({"disp": disp[None]}, want)
    assert nums["disp_median_px"] < MEDIAN_PX and nums["disp_p99_px"] < P99_PX, nums
    assert float(np.abs(want).std()) > 0.5   # a map, not a constant
    assert occ is None and conf is None and score is None


def test_the_lower_precision_control_misses_the_bounds():
    _, model = program_and_reference(4)
    left, right = pair()
    want = ARCH.reference_request(model, left[None], right[None], "cpu")
    control = ARCH.CONTROLS["ref_tf32"](model, "cpu")
    disp = control.run(left, right)[0]
    nums = ARCH.numbers({"disp": disp[None]}, want)
    assert nums["disp_median_px"] > MEDIAN_PX or nums["disp_p99_px"] > P99_PX, nums


@pytest.mark.parametrize("fault", sorted(ARCH.FAULTS))
def test_each_fault_moves_the_program(fault):
    eng, _ = program_and_reference(4)
    left, right = pair()
    base = eng.run(left, right)[0]
    with ARCH.FAULTS[fault]():
        broken = eng.run(left, right)[0]
    assert np.median(np.abs(broken - base)) > 100 * MEDIAN_PX


def test_lookup_equals_grid_sample_on_the_published_layout():
    """Four levels of 9 taps, positions off both ends of every level, against
    the published CorrBlock1D's pooling and bilinear_sampler."""
    g = torch.Generator().manual_seed(0)
    b, h, w = 2, 3, 40
    vol = torch.randn(b, h, w, w, generator=g)
    x = torch.rand(b, h, w, generator=g) * 70 - 15
    got = torch.cat(cv.lookup_pyramid(cv.make_pyramid(vol, 4), x, cv.taps(4, "cpu")), dim=1)
    corr = vol.reshape(b * h * w, 1, 1, w)
    levels = [corr]
    for _ in range(3):
        levels.append(F.avg_pool2d(levels[-1], [1, 2], stride=[1, 2]))
    pyramid = cv.make_pyramid(vol, 4)
    for mine, theirs in zip(pyramid, levels):
        assert torch.equal(mine.reshape(theirs.shape), theirs)
    dx = torch.linspace(-4, 4, 9).view(9, 1)
    want = []
    for i, lvl in enumerate(levels):
        x0 = dx + x.reshape(b * h * w, 1, 1, 1) / 2 ** i
        want.append(ref.bilinear_sampler(lvl, torch.cat([x0, torch.zeros_like(x0)], -1))
                    .view(b, h, w, -1))
    want = torch.cat(want, dim=-1).permute(0, 3, 1, 2)
    assert (want == 0).any() and (want != 0).any()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_s2m2_lookup_is_the_two_level_formula_to_the_bit():
    """S2M2's refiner reads the first two levels at column - disparity, as
    the benchmark's S2M2 reference writes it out."""
    g = torch.Generator().manual_seed(1)
    vol = torch.randn(1, 3, 16, 16, generator=g)
    disp = torch.rand(1, 1, 3, 16, generator=g) * 28 - 6
    got = cv.cost_volume_lookup(cv.make_cost_volume(vol), disp)
    want = s2m2_ref.lookup(vol, disp, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_convex_upsampling_pads_with_zeros():
    """All of each mask's weight on the top-left tap: the fine pixels of the
    top row and left column read the zero padding, the others the coarse
    neighbour up and to the left, times the factor; as the reference's."""
    h, w, f = 3, 4, 4
    flow = torch.arange(1.0, 1.0 + h * w).view(1, 1, h, w)
    mask = torch.full((1, 9, f, f, h, w), -1e4)
    mask[:, 0] = 1e4
    up = raft_stereo.convex_upsample(flow, mask.view(1, 9 * f * f, h, w), f)
    assert up.shape == (1, 1, f * h, f * w)
    coarse = up[0, 0, ::f, ::f]
    assert torch.all(coarse[0] == 0) and torch.all(coarse[:, 0] == 0)
    assert torch.equal(coarse[1:, 1:], f * flow[0, 0, :-1, :-1])
    model = ref.RAFTStereo(CFG)
    want = model.upsample_flow(torch.cat([flow, flow]).view(1, 2, h, w),
                               mask.view(1, 9 * f * f, h, w))
    assert torch.equal(up, want[:, :1])


def test_engine_runs_raft_stereo_and_refuses_what_it_lacks():
    eng = StereoEngine(RaftStereoConfig(), precision="fp32", device="cpu")
    left = np.random.default_rng(0).uniform(0, 255, (70, 100, 3)).astype(np.float32)
    disp, occ, conf, score, ms = eng.run(left, np.roll(left, -5, axis=1))
    assert disp.shape == (70, 100) and disp.dtype == np.float32 and np.isfinite(disp).all()
    assert occ is None and conf is None and score is None and ms > 0
    for kwargs in ({"precision": "bf16"}, {"precision": "int8"}, {"precision": "int8r"},
                   {"precision": "fp32", "mesh": object()},
                   {"precision": "fp32", "fused_block": True}):
        with pytest.raises(ValueError, match="RAFT-Stereo"):
            StereoEngine(RaftStereoConfig(), device="cpu", **kwargs)
    with pytest.raises(ValueError, match="makes no confidence"):
        eng.confidence_score(left, left)
    # the published options the program has no field for: the benchmark's
    # configuration states their defaults, and the reference refuses others
    for bad in ({"shared_backbone": True}, {"slow_fast_gru": True}, {"n_gru_layers": 2},
                {"corr_implementation": "alt"}, {"mixed_precision": True},
                {"context_norm": "instance"}):
        with pytest.raises(ValueError, match="only the settings the benchmark uses"):
            ref.RAFTStereo(dict(CFG, **bad))


def test_parameter_names_are_the_references_and_a_published_checkpoint_loads(tmp_path):
    """The same parameters and buffers under the same names; a state dict
    saved as the published training saves it (DataParallel's `module.`
    prefix) loads into the engine by name."""
    program = raft_stereo.RAFTStereo(RaftStereoConfig())
    model = ref.RAFTStereo(CFG)
    assert list(dict(program.named_parameters())) == list(dict(model.named_parameters()))
    theirs = {k: v.shape for k, v in model.state_dict().items()}
    assert {k: v.shape for k, v in program.state_dict().items()} == theirs
    assert "update_block.gru08.convz.weight" in theirs
    assert "cnet.layer2.0.downsample.1.running_var" in theirs
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            if t.is_floating_point():
                t.uniform_(0.5, 1.5)
    state = model.state_dict()  # a batch norm's norm3 is also its downsample.1
    path = tmp_path / "raftstereo.pth"
    torch.save({f"module.{k}": v for k, v in state.items()}, path)
    eng = StereoEngine(RaftStereoConfig(), checkpoint=str(path), precision="fp32", device="cpu")
    got = eng.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in state.items())


def test_spans_and_counters_of_a_raft_call():
    eng = StereoEngine(RaftStereoConfig(iters=3), precision="fp32", device="cpu")
    left, right = pair()
    trace.take()
    before = trace.counters()
    trace.enable()
    try:
        eng.run(np.stack([left, left]), np.stack([right, right]))
        spans, after = trace.take()
    finally:
        trace.disable()
    names = [s.name for s in spans]
    stages = ["forward.encode", "forward.correlation", "forward.update", "forward.upsample"]
    assert [n for n in names if n.startswith("forward.")] == stages
    forward = names.index("run.forward")
    assert all(spans[names.index(s)].parent == forward for s in stages)
    assert after["raft.iters"] - before.get("raft.iters", 0) == 3 * 2
    h4, w4 = H // 4, W // 4
    levels = sum(w4 >> i for i in range(4))
    assert after["corr.volume_bytes"] - before.get("corr.volume_bytes", 0) == \
        2 * h4 * w4 * levels * 4
    assert after["run.pairs"] - before.get("run.pairs", 0) == 2
