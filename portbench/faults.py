"""Faults planted in the program under test, for the check's own tests and
for `readings.py`: each breaks the timed path underneath the harness, and
the comparison with the reference has to come out as not correct. They are
the `FAULTS` of the cell's architecture (`archs/<name>.py`), each a
function that returns a context manager.

    with faults.plant(cell, "disp_plus1"):
        harness.run_cell(cell, ...)

The benchmark's own runs never plant one.
"""
from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def plant(cell, name: str):
    with cell.arch.FAULTS[name]():
        yield
