"""Share of the attention kernels' roofline, in %: the least time of the
attention calls the cell's shapes make (its architecture's
`attention_bound_ms`, in `archs/<architecture>.py`) over the device time
of the attention family in the profiled slice. None where the
architecture counts no attention kernels."""


def read(rec):
    return rec.attn_roofline()
