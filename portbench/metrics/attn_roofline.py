"""Share of the attention kernels' roofline, in %: the least time of the A
and B calls the cell's shapes make (yardstick.bound, summed) over the device
time of the attention family in the profiled slice."""


def read(rec):
    return rec.attn_roofline()
