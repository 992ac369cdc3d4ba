"""Device ms a pair of the convolution family (cuDNN) in the profiled slice."""


def read(rec):
    return rec.family_ms_per_pair("convolution")
