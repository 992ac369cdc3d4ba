"""Seconds from the process's start to the first timed call: imports,
inputs and weights, the engine, any kernel build, the warm calls."""


def read(rec):
    return rec.setup_s
