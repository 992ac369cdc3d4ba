"""Device ms a pair of the library's elementwise and copy/layout kernels in
the profiled slice."""


def read(rec):
    return rec.family_ms_per_pair("elementwise", "copy / layout")
