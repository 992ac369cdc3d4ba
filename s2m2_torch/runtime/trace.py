"""Spans and counters of s2m2_torch: where a call's time and bytes go.

Spans time the layer boundaries of the program (README, "Tracing"):
`engine.run` and its phases `run.prepare`, `run.forward` (with
`run.upload` and the model's stages `forward.encode`,
`forward.transformer`, `forward.match`, `forward.refine`,
`forward.upsample` inside it; RAFT-Stereo's `forward.encode`,
`forward.correlation`, `forward.update`, `forward.upsample`),
`run.download` and `run.finish`;
`engine.init`; `kernels.load`, the first load of each kernel library,
its build included.

Tracing is off by default, and then `span` costs one flag check and
returns the shared `NOOP` context: no clock read, no torch call, nothing
recorded. `enable()` turns it on for the process: each span is recorded
on `time.perf_counter_ns()` into a bounded buffer (spans beyond
`capacity` are dropped and counted under `trace.dropped`), and while a
`torch.profiler` is recording, the span is also a
`torch.profiler.record_function` of the same name, so it sits in the
profiler's trace on the clock of the device operations. While
`torch.export` or `torch.compile` traces, spans do nothing. `take()`
returns the recorded spans and a snapshot of the counters; nothing is
written anywhere.

Counters are always on, in one table for the process: `bytes.h2d` and
`bytes.d2h` (host bytes `StereoEngine.run` hands to and takes from the
device), `run.pairs` (stereo pairs `run` served), `kernels.built` (each
nvcc or g++ build in this process), `kernels.loaded` (each kernel library
loaded), `trace.dropped`, `corr.volume_bytes` (bytes of the correlation
pyramid levels built), `raft.iters` (RAFT-Stereo's iterations run, times
the pairs), and `launch.<kernel>`, which `counters()` reads from
`ops/_build.py`'s `launch_counts`.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd.profiler import record_function

DEFAULT_CAPACITY = 100_000


class Span(NamedTuple):
    """One recorded span. `parent` is the index of the enclosing span in
    the same `take()`'s list, None for a root (or for a parent taken
    earlier or dropped); spans of one root share `request`. `end_ns` is
    None for a span still open when it was taken."""
    name: str
    request: int
    parent: Optional[int]
    start_ns: int
    end_ns: Optional[int]
    attrs: dict


class _Noop:
    """The context every span is while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NOOP = _Noop()

_on = False
_capacity = 0
_buffer: list = []          # [name, request, parent, start_ns, end_ns, attrs] a span
_base = 0                   # the running index of _buffer[0]
_requests = itertools.count()
_local = threading.local()  # .stack: [(running index or None, request)] of open spans
_lock = threading.Lock()
_counters: dict = {}


class _Span:
    __slots__ = ("name", "attrs", "rec", "rf")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs
        self.rec = None
        self.rf = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent, request = stack[-1] if stack else (None, next(_requests))
        if torch._C._autograd._profiler_enabled():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        with _lock:
            if len(_buffer) < _capacity:
                index = _base + len(_buffer)
                self.rec = [self.name, request, parent, 0, None, self.attrs]
                _buffer.append(self.rec)
            else:
                index = None
                _counters["trace.dropped"] = _counters.get("trace.dropped", 0) + 1
        stack.append((index, request))
        if self.rec is not None:
            self.rec[3] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec[4] = time.perf_counter_ns()
        _local.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False

    def set(self, **attrs):
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager timing `name`; the shared `NOOP` while tracing is
    off or while torch.export / torch.compile traces."""
    if not _on:
        return NOOP
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return NOOP
    return _Span(name, attrs)


def enable(capacity: int = DEFAULT_CAPACITY):
    """Record spans from now on, at most `capacity` until the next take()."""
    global _on, _capacity
    if capacity < 1:
        raise ValueError(f"capacity must be at least 1, got {capacity}")
    _capacity = capacity
    _on = True


def disable():
    """Stop recording; the spans recorded so far stay until take()."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def count(name: str, n: int = 1):
    """Add n to counter `name` (always on)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """A snapshot of every counter, the kernels' launch counts as
    `launch.<kernel>` among them."""
    from ..ops import _build
    with _lock:
        out = dict(_counters)
    out.update((f"launch.{k}", v) for k, v in _build.launch_counts.items())
    return out


def take():
    """(the spans recorded since the last take(), in the order they
    started, as `Span`s; `counters()`). Clears the spans, not the
    counters."""
    global _buffer, _base
    with _lock:
        recs, first = _buffer, _base
        _buffer = []
        _base += len(recs)
    spans = [Span(name, request, parent - first if parent is not None and parent >= first
                  else None, start, end, attrs)
             for name, request, parent, start, end, attrs in recs]
    return spans, counters()
