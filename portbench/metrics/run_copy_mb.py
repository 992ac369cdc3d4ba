"""MB a pair that StereoEngine.run copies between host and card: the
program's counters `bytes.h2d` + `bytes.d2h` over its `run.pairs`, read
from the program in this process at the end of the run (every call of
the process, the warm calls too, moves the same bytes). None where the
program has no such counters."""


def read(rec):
    try:
        from s2m2_torch.runtime import trace
    except ImportError:
        return None
    counts = trace.counters()
    pairs = counts.get("run.pairs", 0)
    if not pairs:
        return None
    return (counts.get("bytes.h2d", 0) + counts.get("bytes.d2h", 0)) / pairs / 1e6
