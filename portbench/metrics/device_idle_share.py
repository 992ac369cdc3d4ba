"""1 - the union of device operations' intervals over the profiled slice's
wall time."""


def read(rec):
    return rec.idle_share()
