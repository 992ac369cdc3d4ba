"""Reading the program's spans and counters: device operations go to the
span open at their launch, idle time to the span the host was in, the
readings of spans.py, the run_copy_mb
reader, and a `--trace 0` run leaves the program's tracer off."""
import json
from pathlib import Path

import pytest

from portbench import harness, spans, trace
from portbench.tests.conftest import write_root
from s2m2_torch.runtime import trace as program

ROOT = Path(__file__).resolve().parents[2]


def _ann(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2,
            "args": {"correlation": corr}}


def _kernel(name, corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def test_device_ops_go_to_the_span_open_at_their_launch(tmp_path):
    """The host runs ahead: every kernel runs after the span that launched
    it has closed, inside a later span. Execution time would give
    encode's kernels to match and match's to the download."""
    events = [
        _ann(trace.CALL_SPAN, 0, 1000),
        _ann("engine.run", 1, 998),
        _ann("run.forward", 10, 700),
        _ann("run.upload", 11, 9),
        _ann("forward.encode", 20, 30),
        _ann("forward.match", 50, 20),
        _ann("run.download", 710, 280),
        _launch(1, 12), _kernel("Memcpy HtoD (Pageable -> Device)", 1, 60, 20, "gpu_memcpy"),
        _launch(2, 25), _kernel("sm90_xmma_fprop_implicit_gemm", 2, 81, 300),
        _launch(3, 30), _kernel("vectorized_elementwise_kernel", 3, 381, 50),
        _launch(4, 55), _kernel("corr_ot_kernel", 4, 431, 200),
        _launch(5, 72), _kernel("fill", 5, 640, 5, "gpu_memset"),   # run.forward's self time
        _launch(6, 720), _kernel("Memcpy DtoH (Device -> Pageable)", 6, 730, 100, "gpu_memcpy"),
        _kernel("no launch event", 7, 900, 10),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 75, "dur": 600,
         "args": {}},
    ]
    by_span, outside, total = spans.attribute(events)
    assert by_span == {"run.upload": 20.0, "forward.encode": 350.0, "forward.match": 200.0,
                       "run.forward": 5.0, "run.download": 100.0}
    assert outside == 10.0 and total == 685.0
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    # the slice's idle gaps now name the program's spans
    labels = [g[0] for g in trace.Slice.from_chrome_trace(path, 1).breakdown()["idle_gaps"]]
    assert {"host: forward.encode", "host: run.forward", "host: run.download"} <= set(labels)
    assert "host: run() outside torch ops" not in labels
    # each idle instant goes to the innermost span the host was in
    sl = trace.Slice.from_chrome_trace(path, 1)
    assert spans.idle_by_span(sl.gaps(), spans.annotations(events)) == {
        "run() outside spans": 2.0, "engine.run": 18.0, "run.forward": 76.0, "run.upload": 9.0,
        "forward.encode": 30.0, "forward.match": 10.0, "run.download": 170.0}
    assert spans.idle_by_span([(1000, 1010)], spans.annotations(events)) == {
        "between calls": 10.0}


def _span(name, request, parent, start_ms, end_ms, **attrs):
    return program.Span(name, request, parent, int(start_ms * 1e6), int(end_ms * 1e6), attrs)


def test_readings_of_the_spans():
    setup = [_span("engine.init", 0, None, 0, 1500),
             _span("engine.run", 1, None, 2000, 9000),
             _span("kernels.load", 1, 0, 2100, 2400, library="scanline_attention", built=False),
             _span("kernels.load", 1, 0, 2400, 2450, library="s2m2_preprocess", built=True)]
    got = spans.setup_readings(setup)
    assert got["engine_init_s"] == pytest.approx(1.5)
    assert got["kernel_load_s"] == pytest.approx(0.35)
    assert set(got["loads_s"]) == {"scanline_attention", "s2m2_preprocess (built)"}

    window = []
    for k, t in enumerate((0, 200, 400)):
        window += [_span("engine.run", 10 + k, None, t, t + 150),
                   _span("run.upload", 10 + k, 0, t + 10, t + 10 + 4 * (k + 1)),
                   _span("run.download", 10 + k, 0, t + 100, t + 100 + 8 * (k + 1))]
    calls = spans.calls_of(window)
    assert [c["run.upload"] for c in calls] == pytest.approx([4, 8, 12])
    out = spans.window_readings(calls, [False, True, False],
                                {"forward.refine": 3000.0, "run.download": 500.0}, 25.0, 3525.0,
                                2, {"run.pairs": 4, "bytes.h2d": 8e6, "bytes.d2h": 4e6},
                                {"run.prepare": 3000.0, "forward.encode": 5000.0})
    assert out["run_copy_ms"] == pytest.approx((4 + 8 + 12 + 24) / 2)  # calls 1 and 3
    assert out["refine_ms_per_pair"] == pytest.approx(1.5)
    assert out["encode_ms_per_pair"] == 0.0
    assert out["device_ms_per_pair[run.download]"] == pytest.approx(0.25)
    assert out["run_copy_mb"] == pytest.approx(3.0)
    assert out["uncovered_ms_per_pair"] == pytest.approx(0.0125)
    assert out["uncovered_share"] == pytest.approx(25 / 3525)
    idle = [k for k in out if k.startswith("idle_ms_per_pair")]
    assert idle == ["idle_ms_per_pair[forward.encode]", "idle_ms_per_pair[run.prepare]"]
    assert out[idle[1]] == pytest.approx(1.5)


def _record():
    cell = harness.Cell("x", 1, {}, {"batch": 1, "height": 1024, "width": 1216}, {}, {}, ROOT)
    return harness.Record(cell, 10.0, 1.0, [harness.Call(100.0, 90.0, 1, False)])


def test_run_copy_mb_reader(monkeypatch):
    read = harness.reader(ROOT, "run_copy_mb")
    # S's call: two 1024x1216x3 float32 frames up, three 1024x1216 float32 maps down
    monkeypatch.setattr(program, "counters", lambda: {
        "run.pairs": 7, "bytes.h2d": 7 * 29884416, "bytes.d2h": 7 * 14942208})
    assert read(_record()) == pytest.approx(44.826624)
    monkeypatch.setattr(program, "counters", lambda: {"bytes.h2d": 5})
    assert read(_record()) is None


def test_a_trace_0_run_leaves_the_tracer_off(tmp_path, monkeypatch):
    enabled = []
    monkeypatch.setattr(program, "enable", lambda *a, **k: enabled.append(a))
    program.take()
    root = write_root(tmp_path, {"conf_median": 1.0})
    cell = harness.load_cell("tiny.stream", False, root)
    res = harness.run_cell(cell, 2**31 + 13, 0.5, False, device="cpu", log=lambda _: None)
    assert res["correct"]
    assert enabled == [] and not program.enabled()
    assert program.take()[0] == []
