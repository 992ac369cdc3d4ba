"""Faults planted in the program under test, for the check's own tests and
for `readings.py`: each breaks the timed path underneath the harness, and
the comparison with the reference has to come out as not correct.

    with faults.plant("disp_plus1"):
        harness.run_cell(...)

The benchmark's own runs never plant one.
"""
from __future__ import annotations

from contextlib import contextmanager
from unittest import mock


def _refiner_unchanged():
    """The local refiner's step returns its state unchanged."""
    from s2m2_torch.models import refiners
    return mock.patch.object(
        refiners.LocalRefiner, "forward",
        lambda self, hidden, ctx, disp, conf, occ, cv: (hidden, disp.float(), conf.float(),
                                                        occ.float()))


def _disp_plus1():
    """The disparity one pixel off where the model produces it."""
    from s2m2_torch.models import s2m2
    forward = s2m2.S2M2.forward

    def altered(self, img0, img1, return_aux=False):
        disp, occ, conf = forward(self, img0, img1)
        return disp + 1.0, occ, conf

    return mock.patch.object(s2m2.S2M2, "forward", altered)


def _half_batch():
    """Half of a batch left out: the first half's maps served for all."""
    from s2m2_torch.runtime import engine
    forward = engine.StereoEngine.forward_padded

    def half(self, img0, img1):
        k = max(1, len(img0) // 2)
        outs = forward(self, img0[:k], img1[:k])
        return tuple(o.repeat(len(img0) // k, 1, 1, 1) for o in outs)

    return mock.patch.object(engine.StereoEngine, "forward_padded", half)


FAULTS = {"refiner_unchanged": _refiner_unchanged, "disp_plus1": _disp_plus1,
          "half_batch": _half_batch}


@contextmanager
def plant(name: str):
    with FAULTS[name]():
        yield
