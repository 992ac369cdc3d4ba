"""The port's spans and counters (s2m2_torch/runtime/trace.py) on the CPU:
free and silent when off; when on, one `run` records its phases and the
model's five stages, nested and in order, under one request id, in memory
and in a recording torch.profiler's trace; counters of bytes, pairs,
builds and launches in one table; the maps and the exported program are
the same with tracing on."""
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from s2m2_torch import native
from s2m2_torch.config import ModelConfig
from s2m2_torch.models.init import init_params
from s2m2_torch.ops import _build
from s2m2_torch.runtime import trace
from s2m2_torch.runtime.engine import StereoEngine
from s2m2_torch.tools import export as ex

torch.set_num_threads(2)
SMALL = ModelConfig(feature_channels=16, num_transformer=1, refine_iter=1)
H, W = 64, 96
RUN = ["engine.run", "run.prepare", "run.forward", "run.upload", "forward.encode",
       "forward.transformer", "forward.match", "forward.refine", "forward.upsample",
       "run.download", "run.finish"]
PARENT = {"engine.run": None, "run.prepare": "engine.run", "run.forward": "engine.run",
          "run.download": "engine.run", "run.finish": "engine.run",
          "run.upload": "run.forward", **{s: "run.forward" for s in RUN[4:9]}}


@pytest.fixture(scope="module")
def engine():
    eng = StereoEngine(SMALL, precision="fp32", device="cpu")
    eng.run(*frames(1))  # warm
    return eng


def frames(batch, seed=0):
    rng = np.random.default_rng(seed)
    shape = (H, W, 3) if batch == 1 else (batch, H, W, 3)
    left = rng.uniform(0, 255, shape).astype(np.float32)
    return left, np.roll(left, -4, axis=-2)


@pytest.fixture
def tracer():
    """The tracer on, with nothing recorded; off and emptied afterwards."""
    trace.take()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.take()


def _check_run(spans):
    """The spans of one run: names in order, one request, the tree, and
    the children of run.forward and of engine.run tiling them in order."""
    assert [s.name for s in spans] == RUN
    assert len({s.request for s in spans}) == 1
    for s in spans:
        assert (spans[s.parent].name if s.parent is not None else None) == PARENT[s.name]
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    for parent in ("engine.run", "run.forward"):
        kids = [s for s in spans if s.parent is not None and spans[s.parent].name == parent]
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))


def test_off_records_nothing_and_returns_the_shared_noop(engine):
    trace.take()
    assert not trace.enabled()
    assert trace.span("engine.run") is trace.NOOP
    assert trace.span("kernels.load", library="x") is trace.NOOP
    with trace.span("x") as s:
        s.set(built=True)
    engine.run(*frames(1))
    assert trace.take()[0] == []


@pytest.mark.parametrize("batch", [1, 2])
def test_one_run_records_its_phases_and_stages(engine, tracer, batch):
    engine.run(*frames(batch))
    spans, _ = trace.take()
    _check_run(spans)
    assert spans[0].attrs == {"batch": batch, "h": H, "w": W}


def test_run_forward_is_the_interval_runtime_ms_times(engine, tracer):
    for _ in range(3):
        ms = engine.run(*frames(1))[4]
        spans, _ = trace.take()
        fwd = next(s for s in spans if s.name == "run.forward")
        assert (fwd.end_ns - fwd.start_ns) / 1e6 == pytest.approx(ms, abs=0.05)


def test_two_runs_get_two_requests(engine, tracer):
    engine.run(*frames(1))
    engine.run(*frames(1, seed=1))
    spans, _ = trace.take()
    _check_run(spans[:len(RUN)])
    second = spans[len(RUN):]
    assert [s.parent - len(RUN) if s.parent is not None else None for s in second] == \
        [s.parent for s in spans[:len(RUN)]]
    assert spans[0].request != second[0].request


@pytest.mark.parametrize("batch", [1, 2])
def test_counters_count_bytes_pairs_and_launches(engine, batch):
    """Always on, tracing off included; launch.* is _build.launch_counts."""
    left, right = frames(batch)
    before = trace.counters()
    disp, occ, conf, _, _ = engine.run(left, right)
    after = trace.counters()
    assert after["bytes.h2d"] - before.get("bytes.h2d", 0) == left.nbytes + right.nbytes
    assert after["bytes.d2h"] - before.get("bytes.d2h", 0) == \
        disp.nbytes + occ.nbytes + conf.nbytes
    assert after["run.pairs"] - before.get("run.pairs", 0) == batch
    _build.launch_counts["scanline_attention"] += 3
    try:
        launches = {k[len("launch."):]: v for k, v in trace.counters().items()
                    if k.startswith("launch.")}
        assert launches == _build.launch_counts
    finally:
        _build.launch_counts["scanline_attention"] -= 3


def test_spans_are_user_annotations_in_the_profilers_trace(engine, tracer, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.run(*frames(1))
    spans, _ = trace.take()
    _check_run(spans)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert Counter(e["name"] for e in events) == Counter(s.name for s in spans)

    def parent(e):
        around = [o for o in events if o is not e and o["ts"] <= e["ts"]
                  and e["ts"] + e["dur"] <= o["ts"] + o["dur"]]
        return min(around, key=lambda o: o["dur"])["name"] if around else None

    assert sorted((e["name"], parent(e)) for e in events) == \
        sorted((s.name, PARENT[s.name]) for s in spans)


@pytest.mark.parametrize("batch", [1, 2])
def test_maps_are_bitwise_equal_with_tracing_on(engine, batch):
    left, right = frames(batch, seed=2)
    off = engine.run(left, right)
    trace.enable()
    try:
        on = engine.run(left, right)
    finally:
        trace.disable()
        trace.take()
    for a, b in zip(off[:3], on[:3]):
        assert np.array_equal(a, b)
    assert off[3] == on[3]


def test_exported_program_is_the_same_with_tracing_on(tracer):
    """Spans are no-ops while torch.export traces, even under a recording
    profiler, so no profiler op enters the program."""
    state = init_params(SMALL, seed=0)
    text = ex.export_program_text(state, SMALL, 32, 64, compute_dtype=torch.float32,
                                  device="cpu")
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = ex.export_program_text(state, SMALL, 32, 64, compute_dtype=torch.float32,
                                        device="cpu")
    assert traced == text and "record_function" not in traced
    assert [s.name for s in trace.take()[0]] == []


def test_spans_past_capacity_are_dropped_and_counted(engine):
    dropped = trace.counters().get("trace.dropped", 0)
    trace.take()
    trace.enable(capacity=4)
    try:
        engine.run(*frames(1))
        spans, counters = trace.take()
    finally:
        trace.disable()
        trace.take()
    assert [s.name for s in spans] == RUN[:4]
    assert counters["trace.dropped"] - dropped == len(RUN) - 4
    assert all(s.end_ns is not None for s in spans)
    with pytest.raises(ValueError):
        trace.enable(capacity=0)


def test_first_library_load_is_a_span(tracer, monkeypatch):
    """native's host library, loaded afresh: one kernels.load span and one
    kernels.loaded count."""
    monkeypatch.setattr(native, "_lib", None)
    loaded = trace.counters().get("kernels.loaded", 0)
    native.image_pad(np.zeros((30, 40, 3), np.float32))
    spans, counters = trace.take()
    loads = [s for s in spans if s.name == "kernels.load"]
    assert len(loads) == 1 and loads[0].attrs["library"] == "s2m2_preprocess"
    assert isinstance(loads[0].attrs["built"], bool)
    assert counters["kernels.loaded"] == loaded + 1
