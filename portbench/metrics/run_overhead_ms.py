"""Host ms of StereoEngine.run outside its forward (float conversion, pad,
device-to-host copy, crop, score): the host clock around run less run's own
runtime_ms, the mean over the calls outside the profiled slice (the
profiler slows the host)."""


def read(rec):
    calls = [c for c in rec.calls if not c.traced]
    if not calls:
        return None
    return sum(c.host_ms - c.runtime_ms for c in calls) / len(calls)
