"""Device ms a pair of the correlation lookup's gathers in the profiled
slice (the family "correlation lookup" of the cell's architecture's
FAMILIES; None where the trace holds no device operations)."""


def read(rec):
    return rec.family_ms_per_pair("correlation lookup")
