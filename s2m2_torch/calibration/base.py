"""Shared self-calibration objective (reference: src/s2m2/calibration/base.py).

The frozen stereo model is a black-box fitness function: apply a candidate
delta rotation to the extrinsics, re-rectify on the host (numpy maps and the
native remap, no OpenCV), and score the pair by the engine's interior mean
confidence (`engine.confidence_score(left, right)`, normally
s2m2_torch.runtime.engine.StereoEngine).

As in s2m2_tpu/calibration/base.py a candidate whose geometry or calibration
dict is unusable scores 0.0, so a stochastic search survives it; unlike
there, only those errors are caught (KeyError, TypeError, ValueError and
LinAlgError while building the maps and remapping). The engine is called
outside the `try`: an engine that fails to build or launch a kernel raises
out of the search instead of scoring every candidate 0.0.

`candidate_log`: a list to which each call appends one record, the host ms
to build the maps (`maps_ms`) and to remap (`remap_ms`), the ms of the
engine call (`score_ms`) and the `score` (a candidate that scored 0.0 for
an error also has `error`); the searches pass theirs on. None (the
default) records nothing.
"""
from __future__ import annotations

import time

import numpy as np

from ..utils.calib import compute_stereo_rectification, create_delta_rotation
from ..utils.image import rectify_images

GEOMETRY_ERRORS = (KeyError, TypeError, ValueError, np.linalg.LinAlgError)


def evaluate_sample(engine, left, right, calib_data, roll_delta, pitch_delta,
                    yaw_delta, candidate_log=None):
    """Confidence of the pair under a (roll, pitch, yaw) extrinsic delta."""
    h, w = left.shape[:2]
    t0 = time.perf_counter()
    rec = {"maps_ms": None, "remap_ms": None, "score_ms": None}
    if candidate_log is not None:
        candidate_log.append(rec)
    try:
        delta_R = create_delta_rotation(roll_delta, pitch_delta, yaw_delta)
        rect = compute_stereo_rectification(calib_data, (w, h), delta_R)
        t1 = time.perf_counter()
        left_r, right_r = rectify_images(left, right, rect)
    except GEOMETRY_ERRORS as e:
        print(f"Error evaluating sample: {e!r}")
        rec.update(score=0.0, error=repr(e))
        return 0.0
    t2 = time.perf_counter()
    score = engine.confidence_score(left_r, right_r)
    score = score if score is not None else 0.0
    rec.update(maps_ms=(t1 - t0) * 1e3, remap_ms=(t2 - t1) * 1e3,
               score_ms=(time.perf_counter() - t2) * 1e3, score=score)
    return score
