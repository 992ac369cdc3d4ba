"""MB a pair of correlation pyramid levels the program built: its counters
`corr.volume_bytes` over `run.pairs`, read from the program in this process
at the end of the run (every call of the process, the warm calls too,
builds the same pyramid). None where the program has no such counters."""


def read(rec):
    try:
        from s2m2_torch.runtime import trace
    except ImportError:
        return None
    counts = trace.counters()
    pairs = counts.get("run.pairs", 0)
    if not pairs or "corr.volume_bytes" not in counts:
        return None
    return counts["corr.volume_bytes"] / pairs / 1e6
