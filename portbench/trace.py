"""A traced slice of the window, reduced from torch.profiler's Chrome trace.

Device operations are the trace's kernels, copies and fills; host
operations its torch ops and the benchmark's own `portbench.call` spans,
one around each call of the program. The slice runs from the start of the
first call span to the end of the last, on the trace's clock.
"""
from __future__ import annotations

import json
from collections import Counter

from . import yardstick

CALL_SPAN = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def _merge(intervals):
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Slice:
    """Device and host operations of the traced calls; times in us."""

    def __init__(self, device_ops, host_ops, pairs):
        calls = [op for op in host_ops if op[0] == CALL_SPAN]
        if not calls:
            raise ValueError(f"the trace holds no {CALL_SPAN} span")
        self.t0 = min(ts for _, ts, _ in calls)
        self.t1 = max(ts + dur for _, ts, dur in calls)
        self.calls = len(calls)
        self.pairs = pairs
        self.device_ops = [op for op in device_ops if op[1] < self.t1 and op[1] + op[2] > self.t0]
        self.host_ops = host_ops
        self.busy = _merge((max(ts, self.t0), min(ts + dur, self.t1))
                           for _, ts, dur in self.device_ops)

    @classmethod
    def from_chrome_trace(cls, path, pairs):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            op = (e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
            if e.get("cat") in DEVICE_CATS:
                dev.append(op)
            elif e.get("cat") in HOST_CATS:
                host.append(op)
        return cls(dev, host, pairs)

    @property
    def wall_s(self):
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy) / 1e6

    def family_ms(self, *families, table=yardstick.FAMILIES):
        """Device ms of the operations whose family in `table` is one of
        `families`."""
        return sum(dur for name, _, dur in self.device_ops
                   if yardstick.family(name, table) in families) / 1e3

    def gaps(self):
        """(start, end) of each stretch of the slice with nothing on the device."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        return [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]

    def host_activity(self, t):
        """The innermost host operation running at time t."""
        best = None
        for name, ts, dur in self.host_ops:
            if ts <= t <= ts + dur and (best is None or dur < best[1]):
                best = (name, dur)
        if best is None:
            return "host: between calls"
        return "host: run() outside torch ops" if best[0] == CALL_SPAN else f"host: {best[0]}"

    def breakdown(self, n=10):
        ops = Counter()
        for name, _, dur in self.device_ops:
            ops[name[:120]] += dur / 1e6
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops.most_common(n)],
                "idle_gaps": [[self.host_activity((s + e) / 2), (e - s) / 1e6]
                              for s, e in longest]}
