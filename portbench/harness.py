"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result line.

Everything that belongs to one cell is data the harness finds by name:
`BENCHMARK.json` names the cell's configuration, traffic and metrics; the
configuration is `portbench/configs/<config>.json`, the traffic
`portbench/traffic/<traffic>.json`, the correctness limits
`portbench/limits/<cell>.json`, and each metric a reader
`portbench/metrics/<metric>.py` with `read(record)`, which returns a number
or None when the run has nothing for it to read.

What depends on the model is the configuration's `architecture`'s, in
`portbench/archs/<architecture>.py`: `build_engine(cell, device,
precision=None)`, the program's object whose `run(left, right)` the window
calls; `unpack(out)`, run's result as ({map name: (B, H, W) array}, score
or None, run's own forward ms); `sane(maps, score, shape)`, the check of
every call in the window; `reference(cfg)`, the plain float32 module, whose
forward takes a pair of float32 (B, H, W, 3) frames; `layout(module)`, each
parameter's initialisation bound (`weights.py`);
`reference_request(model, left, right, device)`, the reference's outputs
of a request of uint8 frames; `numbers(maps, reference_out)`, the compared
numbers, each the worst over the request's pairs; `FAULTS`, faults planted
in the program (`faults.py`); and optionally `CONTROLS`, lower precisions
in the program's place (`readings.py`), `attention_bound_ms(cfg, h, w,
batch, dtype_name)`, and `FAMILIES`, kernel families tried before
`yardstick.FAMILIES`.

The window is a closed loop with one client: each call of the engine's
`run` waits for the previous one, on host uint8 frames from a pool made
from the seed, cycled so that no call repeats the one before.
"""
from __future__ import annotations

import functools
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import scenes, trace, weights, yardstick

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "s2m2_tpu")
DTYPE_NAMES = {"bf16": "bfloat16", "fp32": "float32"}


@dataclass
class Cell:
    name: str
    chips: int
    config: dict       # portbench/configs/<config>.json
    traffic: dict      # portbench/traffic/<traffic>.json
    limits: dict       # {number: limit}
    metrics: dict      # {metric name: unit} this run reports
    root: Path

    @property
    def arch(self):
        """The module `portbench/archs/<architecture>.py` of the configuration."""
        return architecture(self.root, self.config["architecture"])

    @property
    def model(self):
        return self.config["model"]

    @property
    def shape(self):
        t = self.traffic
        return (t["batch"], t["height"], t["width"])


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, trace_run: bool, root: Path = ROOT) -> Cell:
    spec = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = _read_json(root / conf["file"])
    archs = root / "portbench" / "archs"
    if "architecture" not in config:
        raise ValueError(f"{conf['file']} names no \"architecture\": the name of its file "
                         f"<architecture>.py in {archs}")
    if not (archs / f"{config['architecture']}.py").exists():
        raise FileNotFoundError(f"{conf['file']} names the architecture "
                                f"{config['architecture']!r}, which has no file in {archs}")
    metrics = {}
    for m in spec["per_layer" if trace_run else "end_to_end"]:
        if name in m.get("workloads", [name]):
            metrics[m["name"]] = m["unit"]
    return Cell(name=name, chips=w["chips"], config=config,
                traffic=_read_json(root / "portbench" / "traffic" / f"{w['traffic']}.json"),
                limits=_read_json(root / "portbench" / "limits" / f"{name}.json"),
                metrics=metrics, root=root)


def _load(path: Path, name: str):
    """The module of the Python file at `path`, loaded under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str):
    """The `read` of `metrics/<metric>.py`, or for a dotted name with no file
    of its own (`forward_mfu.batch`), of the file of the name before its
    first dot: one quantity, split by the end-to-end metric it moves."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    if not path.exists():
        path = root / "portbench" / "metrics" / f"{metric.split('.', 1)[0]}.py"
    return _load(path, "portbench_metric_" + metric.replace(".", "_")).read


@functools.lru_cache(maxsize=None)
def architecture(root: Path, name: str):
    """The module `portbench/archs/<name>.py` of the checkout at `root`,
    loaded once, so that a fault planted in it is the one its engine runs."""
    return _load(root / "portbench" / "archs" / f"{name}.py", f"portbench_arch_{name}")


@dataclass
class Call:
    host_ms: float      # host clock around the engine's run
    runtime_ms: float   # run's own forward time
    pairs: int
    traced: bool


@dataclass
class Record:
    """What a run measured; the metric readers take their numbers from it."""
    cell: Cell
    setup_s: float
    window_s: float
    calls: list
    slice: trace.Slice | None = None

    @property
    def pairs(self):
        return sum(c.pairs for c in self.calls)

    @property
    def dtype_name(self):
        return DTYPE_NAMES[self.cell.config["precision"]]

    def flops_per_pair(self):
        b, h, w = self.cell.shape
        return yardstick.model_flops(self.cell.arch.reference, self.cell.model, b, h, w) / b

    def attention_bound_ms_per_pair(self):
        """None where the architecture counts no attention kernels."""
        bound = getattr(self.cell.arch, "attention_bound_ms", None)
        if bound is None:
            return None
        b, h, w = self.cell.shape
        return bound(self.cell.model, h, w, b, self.dtype_name) / b

    def untraced(self):
        return [c for c in self.calls if not c.traced]

    def forward_mfu(self):
        """% of the dense peak: the model's FLOPs of the pairs served outside
        the profiled slice over the host seconds of those calls."""
        calls = self.untraced()
        if not calls:
            return None
        rate = self.flops_per_pair() * sum(c.pairs for c in calls) / (
            sum(c.host_ms for c in calls) / 1e3)
        return 100.0 * rate / yardstick.PEAK_FLOPS[self.dtype_name]

    def family_ms_per_pair(self, *families):
        """Device ms a pair of the kernel families in the profiled slice."""
        if self.slice is None or not self.slice.device_ops:
            return None
        table = getattr(self.cell.arch, "FAMILIES", ()) + yardstick.FAMILIES
        return self.slice.family_ms(*families, table=table) / self.slice.pairs

    def attn_roofline(self):
        """% of the attention calls' least time (the architecture's
        `attention_bound_ms`) over the attention family's device time in the
        profiled slice."""
        ms = self.family_ms_per_pair("attention")
        bound = self.attention_bound_ms_per_pair() if ms else None
        return 100.0 * bound / ms if bound is not None else None

    def idle_share(self):
        if self.slice is None or not self.slice.device_ops:
            return None
        return 1.0 - self.slice.busy_s / self.slice.wall_s


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def cpu_times():
    """The machine's CPU time so far, in ticks, from /proc/stat: (all,
    steal), steal being the time the hypervisor gave this machine's CPUs
    to another guest."""
    with open("/proc/stat") as f:
        fields = [int(x) for x in f.readline().split()[1:]]
    return sum(fields[:8]), fields[7]


def host_line(before, after) -> str:
    """What the host did in the window: the share of CPU time stolen from
    this machine, the load, and the CPU this process ran on at the end,
    with its clock (Linux /proc; the host's speed moves a host-paced cell)."""
    total, steal = (a - b for a, b in zip(after, before))
    with open("/proc/self/stat") as f:
        cpu = int(f.read().rsplit(")", 1)[1].split()[36])
    mhz = "?"
    with open("/proc/cpuinfo") as f:
        for block in f.read().split("\n\n"):
            lines = dict(l.split(":", 1) for l in block.splitlines() if ":" in l)
            if lines.get("processor\t", "").strip() == str(cpu):
                mhz = lines.get("cpu MHz\t\t", "?").strip()
    with open("/proc/loadavg") as f:
        load = f.read().split()[0]
    return (f"host in the window: steal {100.0 * steal / max(total, 1):.2f}% of CPU time, "
            f"load {load}, on CPU {cpu} at {mhz} MHz, {os.cpu_count()} CPUs")


def build_engine(cell: Cell, device, precision=None):
    """The program's engine of the cell (its architecture's `build_engine`);
    `precision` replaces the configuration's."""
    return cell.arch.build_engine(cell, device, precision)


@torch.no_grad()
def set_weights(engine, w: dict):
    """Copy the benchmark's weights into the engine's parameters, each in
    the dtype the engine keeps it in."""
    params = dict(engine.model.named_parameters())
    if params.keys() != w.keys():
        raise KeyError(f"the program's parameters differ from the reference's: "
                       f"{sorted(params.keys() ^ w.keys())[:8]}")
    for name, p in params.items():
        if p.shape != w[name].shape:
            raise ValueError(f"{name}: program {tuple(p.shape)}, reference {tuple(w[name].shape)}")
        p.copy_(w[name])


def cell_weights(cell: Cell, seed: int, device):
    return weights.make(cell.arch, cell.model, seed, device, cell.config["weight_gain"],
                        getattr(torch, DTYPE_NAMES[cell.config["precision"]]))


def make_pool(cell: Cell, seed: int, device):
    t = cell.traffic
    return scenes.pool(seed, t["pool"], t["height"], t["width"], t["max_disp"], t["noise"], device)


def call_inputs(cell: Cell, pool, i):
    """(pool indices, left, right) of call i: batch 1 as HWC frames, more
    pairs as BHWC."""
    b = cell.traffic["batch"]
    idx = tuple((i * b + k) % len(pool) for k in range(b))
    if b == 1:
        return idx, pool[idx[0]][0], pool[idx[0]][1]
    return idx, np.stack([pool[j][0] for j in idx]), np.stack([pool[j][1] for j in idx])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def drive(engine, cell: Cell, pool, seconds: float, seed: int, trace_run: bool, device):
    """The measured window. Returns (calls, window seconds, the calls kept
    for the comparison as [(pool indices, maps)], the pairs of calls that
    failed the architecture's `sane`, the profiler of the traced slice or
    None)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    unpack, sane = cell.arch.unpack, cell.arch.sane
    t = cell.traffic
    keep = t["compare_calls"]
    rng = np.random.default_rng([seed, 1])
    first, last = t["trace_after"], t["trace_after"] + t["trace_calls"] - 1
    calls, sample, insane, prof = [], [], 0, None
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds or (trace_run and i <= last):
        idx, left, right = call_inputs(cell, pool, i)
        traced = trace_run and first <= i <= last
        if traced and i == first:
            _sync(device)
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
        a = time.perf_counter()
        if traced:
            with record_function(trace.CALL_SPAN):
                out = engine.run(left, right)
        else:
            out = engine.run(left, right)
        ms = (time.perf_counter() - a) * 1e3
        if traced and i == last:
            _sync(device)
            prof.stop()
        maps, score, runtime_ms = unpack(out)
        calls.append(Call(ms, runtime_ms, len(idx), traced))
        if not sane(maps, score, cell.shape):
            insane += len(idx)
        # a uniform sample of `keep` calls of the window, drawn from the seed
        if i < keep:
            sample.append((idx, maps))
        else:
            j = int(rng.integers(0, i + 1))
            if j < keep:
                sample[j] = (idx, maps)
        i += 1
    return calls, time.perf_counter() - t0, sample, insane, prof


def reference_model(cell: Cell, seed: int, device):
    """The architecture's plain reference on `device` with the cell's
    weights, run in float32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(device):
        model = cell.arch.reference(cell.model).eval()
    w = cell_weights(cell, seed, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w.pop(name))
    return model


def judge(cell: Cell, sample: list, pool, model, device):
    """Each sampled call's numbers against the reference's outputs for its
    pairs; returns (the worst of each number, pairs that failed a limit)."""
    worst, failed, cache = {}, 0, {}
    for idx, maps in sample:
        if idx not in cache:
            left = np.stack([pool[j][0] for j in idx])
            right = np.stack([pool[j][1] for j in idx])
            cache[idx] = cell.arch.reference_request(model, left, right, device)
        nums = cell.arch.numbers(maps, cache[idx])
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
        if not all(nums[k] <= lim for k, lim in cell.limits.items()):  # NaN fails too
            failed += len(idx)
    return worst, failed


def device_info(device):
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run_cell(cell: Cell, seed: int, seconds: float, trace_run: bool, device="cuda",
             log=print) -> dict:
    """One run of `cell`; returns the result line's object. `log` takes the
    lines printed before it."""
    from s2m2_torch.ops import _build
    pool = make_pool(cell, seed, device)
    engine = build_engine(cell, device)
    set_weights(engine, cell_weights(cell, seed, device))
    _sync(device)
    if trace_run:  # load the profiler's device tracing before the window
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            _sync(device)
    for i in range(cell.traffic["warmup_calls"]):
        engine.run(*call_inputs(cell, pool, i)[1:])
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _build.reset_launch_counts()
    setup_s = process_age_s()

    before = cpu_times()
    calls, window_s, sample, insane, prof = drive(engine, cell, pool, seconds, seed,
                                                  trace_run, device)
    log(host_line(before, cpu_times()))
    rec = Record(cell, setup_s, window_s, calls)
    launches = {k: v / rec.pairs for k, v in _build.launch_counts.items() if v}
    log(f"own-kernel launches a pair: {json.dumps(launches)}")
    half = len(calls) // 2
    for part, cs in (("first half", calls[:half]), ("second half", calls[half:])):
        q = np.percentile([c.host_ms for c in cs], [50, 95]) if cs else [np.nan] * 2
        f = np.median([c.runtime_ms for c in cs]) if cs else np.nan
        log(f"{part} of the window: {len(cs)} calls, host ms p50 {q[0]:.2f} p95 {q[1]:.2f}, "
            f"forward ms p50 {f:.2f}")
    info = device_info(device)
    del engine
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    if prof is not None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            rec.slice = trace.Slice.from_chrome_trace(
                path, sum(c.pairs for c in calls if c.traced))
        info.update(busy_s=rec.slice.busy_s, window_s=rec.slice.wall_s)

    model = reference_model(cell, seed, device)
    worst, failed = judge(cell, sample, pool, model, device)
    del model
    failed += insane

    metrics = {}
    for name, unit in cell.metrics.items():
        value = reader(cell.root, name)(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    checks = {k: {"value": worst[k], "limit": lim} for k, lim in cell.limits.items()}
    result = {"correct": failed == 0, "attempted": rec.pairs,
              "failed": failed, "metrics": metrics, "device": info}
    if rec.slice is not None:
        result["breakdown"] = rec.slice.breakdown()
    result["checks"] = checks
    return result


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that the run may not hold."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))
