"""Finite-difference coordinate-descent self-calibration
(reference: src/s2m2/calibration/grad_descent.py), a copy of
s2m2_tpu/calibration/grad_descent.py.

Per-axis forward-difference gradient (eps=0.01) with a backtracking line
search (shrink x0.25, <=5 tries, keep only improving steps); 5 outer
iterations over (roll, pitch, yaw), early stop at confidence > 0.98.
"""
from __future__ import annotations

import copy

import numpy as np

from ..utils.calib import apply_delta_rotation, euler_to_rotation_matrix
from .base import evaluate_sample

_AXES = ("roll", "pitch", "yaw")


def _axis_update(params, axis, delta):
    p = dict(params)
    p[axis] = p[axis] + delta
    return p


def _coordinate_step(engine, left, right, calib_data, params, axis, eps,
                     step_size, max_searches=5, verbose=True,
                     candidate_log=None):
    log = print if verbose else (lambda *a, **k: None)
    current = evaluate_sample(engine, left, right, calib_data,
                              params["roll"], params["pitch"], params["yaw"],
                              candidate_log=candidate_log)
    probe = _axis_update(params, axis, eps)
    probed = evaluate_sample(engine, left, right, calib_data,
                             probe["roll"], probe["pitch"], probe["yaw"],
                             candidate_log=candidate_log)
    gradient = (probed - current) / eps
    if np.isnan(gradient) or np.isinf(gradient):
        log(f"  invalid gradient for {axis}, skipping")
        return params, current

    best_step = 0.0
    best_conf = current
    if abs(gradient) > 1e-6:
        step = step_size
        for i in range(max_searches):
            cand = _axis_update(params, axis, step * gradient)
            conf = evaluate_sample(engine, left, right, calib_data,
                                   cand["roll"], cand["pitch"], cand["yaw"],
                                   candidate_log=candidate_log)
            if conf > current:
                best_step, best_conf = step, conf
                log(f"  {axis}: improvement at try {i + 1}: "
                    f"{current:.4f} -> {conf:.4f}")
                break
            step *= 0.25
        if best_step == 0.0:
            log(f"  no improvement found for {axis}")
    else:
        log(f"  skipping {axis} update (small gradient)")
    return _axis_update(params, axis, best_step * gradient), best_conf


def gradient_descent_calibration(engine, left, right, calib_data, *,
                                 verbose=True, candidate_log=None, **kwargs):
    """`candidate_log`: a list that gets each candidate's record
    (calibration/base.py)."""
    config = {"max_iterations": 5, "step_size": 0.0001, "eps": 0.01}
    config.update(kwargs)
    log = print if verbose else (lambda *a, **k: None)

    initial_confidence = evaluate_sample(engine, left, right, calib_data,
                                         0, 0, 0, candidate_log=candidate_log)
    log(f"Initial confidence: {initial_confidence:.4f}")

    params = {"roll": 0.0, "pitch": 0.0, "yaw": 0.0}
    current = initial_confidence
    for it in range(config["max_iterations"]):
        if current > 0.98:
            break
        log(f"GD iteration {it + 1}/{config['max_iterations']}")
        for axis in _AXES:
            params, current = _coordinate_step(
                engine, left, right, calib_data, params, axis,
                config["eps"], config["step_size"], verbose=verbose,
                candidate_log=candidate_log)
            log(f"  conf={current:.4f} deltas={params}")

    calib_data_new = copy.deepcopy(calib_data)
    calib_data_new["stereo_extrinsic"]["rotation"] = apply_delta_rotation(
        calib_data["stereo_extrinsic"]["rotation"],
        euler_to_rotation_matrix(params["roll"], params["pitch"],
                                 params["yaw"]))
    return {"roll_delta": params["roll"], "pitch_delta": params["pitch"],
            "yaw_delta": params["yaw"],
            "initial_confidence": initial_confidence,
            "final_confidence": current,
            "calib_data_new": calib_data_new}
