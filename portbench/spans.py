"""The program's own spans read against a profiled slice: device ms of each
forward stage, what `run`'s copies cost, and what set-up is made of.

    python3 portbench/spans.py --workload S_fp32.stream_1216 --seed 7 --seconds 51 \
        [--cost-calls 10]

From the root of a checkout, on a card. One run of the cell as run.py's
`--trace 1` run makes it (harness.drive: the same window, the same
profiled calls), with the program's tracer (s2m2_torch/runtime/trace.py)
on from the start of the process, so the slice's trace also holds the
program's spans as user annotations on the device operations' clock.
Each device operation is given to the innermost program span open when
the host launched it (the launch's correlation id), not when the card ran
it: the host runs ahead of the card. `--cost-calls N` then times the
tracer itself: blocks of N calls with it off and on, no profiler. The
last line of standard output is one JSON object.

The benchmark's runs do not run this: its harness leaves the tracer off.
"""
from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import harness, trace  # noqa: E402

STAGES = ("encode", "transformer", "match", "refine", "upsample")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def annotations(events):
    """(start, end, name) of each user annotation of a Chrome trace: the
    program's spans and the benchmark's call spans."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _innermost(spans, t):
    inner = None
    for s, e, name in spans:
        if s <= t <= e and (inner is None or e - s < inner[1] - inner[0]):
            inner = (s, e, name)
    return inner


def attribute(events):
    """({program span name: device us}, device us launched outside every
    program span, every device op's us) of a Chrome trace's events.
    Program spans are the user annotations other than the benchmark's own
    call span; a device op with no launch event in the trace counts as
    outside."""
    program = [a for a in annotations(events) if a[2] != trace.CALL_SPAN]
    launch_ts, device = {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = float(e["ts"])
        elif cat in trace.DEVICE_CATS:
            device.append((e.get("args", {}).get("correlation"), float(e.get("dur", 0.0))))
    by_span, outside, total = defaultdict(float), 0.0, 0.0
    for corr, dur in device:
        total += dur
        t = launch_ts.get(corr)
        inner = None if t is None else _innermost(program, t)
        if inner is None:
            outside += dur
        else:
            by_span[inner[2]] += dur
    return dict(by_span), outside, total


def idle_by_span(gaps, spans):
    """{span: us} of the device's idle stretches `gaps` ((start, end), as
    `trace.Slice.gaps`), each instant given to the innermost of `spans`
    ((start, end, name)) the host was in; "between calls" outside them
    all, "run() outside spans" where only the benchmark's call span is
    open."""
    edges = sorted({x for s, e, _ in spans for x in (s, e)})
    out = defaultdict(float)
    for g0, g1 in gaps:
        cuts = [g0, *edges[bisect.bisect_right(edges, g0):bisect.bisect_left(edges, g1)], g1]
        for a, b in zip(cuts, cuts[1:]):
            inner = _innermost(spans, (a + b) / 2)
            name = "between calls" if inner is None else inner[2]
            out["run() outside spans" if name == trace.CALL_SPAN else name] += b - a
    return dict(out)


def calls_of(spans):
    """{request id: {span name: host ms}} of each `engine.run` among
    `spans` (runtime.trace.Span records), in call order."""
    out = {}
    for s in spans:
        if s.name == "engine.run":
            out[s.request] = {}
    for s in spans:
        if s.request in out and s.end_ns is not None:
            d = out[s.request]
            d[s.name] = d.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6
    return list(out.values())


def setup_readings(spans):
    """engine_init_s, kernel_load_s and each library's load seconds, from
    the spans recorded in set-up."""
    loads = {f"{s.attrs['library']}{' (built)' if s.attrs.get('built') else ''}":
             (s.end_ns - s.start_ns) / 1e9 for s in spans if s.name == "kernels.load"}
    init = [(s.end_ns - s.start_ns) / 1e9 for s in spans if s.name == "engine.init"]
    return {"engine_init_s": sum(init) if init else None,
            "kernel_load_s": sum(loads.values()), "loads_s": loads}


def window_readings(calls, traced, by_span, outside, total, pairs, counters, idle):
    """The would-be metrics of a window: device ms a pair of each forward
    stage and of the copies, host ms a call of each phase over the calls
    outside the profiled slice (and over those in it), the copies' host
    ms (`run_copy_ms`, outside the slice), MB a pair copied, the device ms no
    program span covers, and the device's idle ms a pair by the span the
    host was in (`idle`, from idle_by_span)."""
    out = {f"{st}_ms_per_pair": by_span.get(f"forward.{st}", 0.0) / 1e3 / pairs
           for st in STAGES}
    for name in ("run.upload", "run.download", "run.forward", "run.prepare", "run.finish",
                 "engine.run"):
        out[f"device_ms_per_pair[{name}]"] = by_span.get(name, 0.0) / 1e3 / pairs
    plain = [c for c, t in zip(calls, traced) if not t]
    profiled = [c for c, t in zip(calls, traced) if t]
    for key, cs in (("host_ms", plain), ("profiled_host_ms", profiled)):
        for name in ("run.upload", "run.download", "run.prepare", "run.finish",
                     "run.forward", "engine.run"):
            if cs:
                out[f"{key}[{name}]"] = sum(c.get(name, 0.0) for c in cs) / len(cs)
    if plain:
        out["run_copy_ms"] = out["host_ms[run.upload]"] + out["host_ms[run.download]"]
    served = counters.get("run.pairs", 0)
    if served:
        out["run_copy_mb"] = (counters.get("bytes.h2d", 0)
                              + counters.get("bytes.d2h", 0)) / served / 1e6
    out["uncovered_ms_per_pair"] = outside / 1e3 / pairs
    out["uncovered_share"] = outside / total if total else None
    out["device_ms_per_pair"] = total / 1e3 / pairs
    for name, us in sorted(idle.items(), key=lambda kv: -kv[1]):
        out[f"idle_ms_per_pair[{name}]"] = us / 1e3 / pairs
    return out


def tracer_cost(engine, cell, pool, n, rounds=3, spans=100_000):
    """What the tracer costs the host, no profiler: the host ms a call in
    alternating blocks of n calls with it off and on (off first), and the
    ns of one empty span off and on and of one count, over `spans` each."""
    from s2m2_torch.runtime import trace as program
    out = {"tracer_off_ms": [], "tracer_on_ms": []}
    for r in range(2 * rounds):
        enabled = r % 2 == 1
        (program.enable if enabled else program.disable)()
        t = time.perf_counter()
        for i in range(n):
            engine.run(*harness.call_inputs(cell, pool, r * n + i)[1:])
        out["tracer_on_ms" if enabled else "tracer_off_ms"].append(
            (time.perf_counter() - t) * 1e3 / n)
        program.take()
    program.disable()
    for key in ("span_ns_off", "span_ns_on"):
        if key == "span_ns_on":
            program.enable(spans)
        t = time.perf_counter_ns()
        for _ in range(spans):
            with program.span("cost"):
                pass
        out[key] = (time.perf_counter_ns() - t) / spans
    program.disable()
    program.take()
    t = time.perf_counter_ns()
    for _ in range(spans):
        program.count("cost")
    out["count_ns"] = (time.perf_counter_ns() - t) / spans
    return out


def measure(cell, seed, seconds, device="cuda", cost_calls=0, log=print):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from s2m2_torch.runtime import trace as program
    program.enable()
    pool = harness.make_pool(cell, seed, device)
    engine = harness.build_engine(cell, device)
    harness.set_weights(engine, harness.cell_weights(cell, seed, device))
    harness._sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        harness._sync(device)
    t = time.perf_counter()
    for i in range(cell.traffic["warmup_calls"]):
        engine.run(*harness.call_inputs(cell, pool, i)[1:])
    harness._sync(device)
    warm_s = time.perf_counter() - t
    setup_s = harness.process_age_s()
    setup_spans, _ = program.take()

    calls, window_s, _, _, prof = harness.drive(engine, cell, pool, seconds, seed, True, device)
    spans, counters = program.take()
    result = {"setup_s": setup_s, "warm_calls_s": warm_s, **setup_readings(setup_spans),
              "window_calls": len(calls), "pairs_per_s": sum(c.pairs for c in calls) / window_s}
    if prof is not None:
        pairs = sum(c.pairs for c in calls if c.traced)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            sl = trace.Slice.from_chrome_trace(path, pairs)
        result["breakdown"] = sl.breakdown()
        result.update(window_readings(calls_of(spans), [c.traced for c in calls],
                                      *attribute(events), pairs, counters,
                                      idle_by_span(sl.gaps(), annotations(events))))
        log(f"device ms a pair no program span covers: {result['uncovered_ms_per_pair']:.3f} "
            f"of {result['device_ms_per_pair']:.3f}")
    if cost_calls:
        result.update(tracer_cost(engine, cell, pool, cost_calls))
    result["counters"] = {k: v for k, v in counters.items() if v}
    return result


def main(argv=None):
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--cost-calls", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload, True)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("portbench/spans.py: no CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    result = measure(cell, args.seed % 2**64, args.seconds, args.device, args.cost_calls,
                     log=lambda line: print(line, flush=True))
    result["device"] = harness.device_info(args.device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
