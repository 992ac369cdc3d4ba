"""Share of the float32 convolution operations that ran on the program's own
kernel (G, split TF32) rather than a library's: the program's counters
`conv.own_flops` / (`conv.own_flops` + `conv.library_flops`), read from the
program in this process at the end of the run (every call of the process
counts, the warm calls too, and each runs the same convolutions). None
where the program has no such counters."""


def read(rec):
    try:
        from s2m2_torch.runtime import trace
    except ImportError:
        return None
    counts = trace.counters()
    own = counts.get("conv.own_flops", 0)
    total = own + counts.get("conv.library_flops", 0)
    if not total:
        return None
    return own / total
