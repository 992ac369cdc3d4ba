"""Cross-entropy-method self-calibration (reference: src/s2m2/calibration/cem.py),
a copy of s2m2_tpu/calibration/cem.py: the same search and the same
`np.random.default_rng(seed)` draws.

Search over (roll, pitch, yaw) extrinsic deltas maximizing the model's
interior confidence: 5 iterations x 20 Gaussian samples, 3 elites,
initial sigma 0.002 rad, sigma decay 0.8 with floor 5e-5, early stop at
confidence > 0.98.
"""
from __future__ import annotations

import copy

import numpy as np

from ..utils.calib import apply_delta_rotation, euler_to_rotation_matrix
from .base import evaluate_sample


def cem_calibration(engine, left, right, calib_data, *, seed=None, verbose=True,
                    candidate_log=None, **kwargs):
    """`candidate_log`: a list that gets each candidate's record
    (calibration/base.py)."""
    config = {"max_iterations": 5, "num_samples": 20, "num_elite": 3,
              "initial_std": 0.002, "std_decay": 0.8}
    config.update(kwargs)
    rng = np.random.default_rng(seed)
    log = print if verbose else (lambda *a, **k: None)

    num_elite = min(config["num_elite"], config["num_samples"])

    initial_confidence = evaluate_sample(engine, left, right, calib_data, 0, 0, 0,
                                         candidate_log=candidate_log)
    log(f"Initial confidence: {initial_confidence:.4f}")

    mean_params = np.zeros(3)
    std_params = np.full(3, config["initial_std"])
    current_confidence = initial_confidence
    best_params = mean_params.copy()
    best_confidence = initial_confidence

    for iteration in range(config["max_iterations"]):
        if best_confidence > 0.98:
            break
        log(f"CEM iteration {iteration + 1}/{config['max_iterations']} "
            f"conf={current_confidence:.4f} mean={mean_params} std={std_params}")

        samples = rng.normal(mean_params, std_params,
                             (config["num_samples"], 3))
        scored = [(mean_params, current_confidence)]
        for s in samples:
            scored.append((s, evaluate_sample(engine, left, right, calib_data,
                                              *s, candidate_log=candidate_log)))
        scored.sort(key=lambda x: x[1], reverse=True)

        elite = np.array([s for s, _ in scored[:num_elite]])
        elite_scores = [c for _, c in scored[:num_elite]]
        mean_params = elite.mean(axis=0)
        std_params = np.maximum(elite.std(axis=0) * config["std_decay"], 5e-5)

        if elite_scores[0] > best_confidence:
            best_confidence = elite_scores[0]
            best_params = elite[0].copy()
            current_confidence = elite_scores[0]
        log(f"  best sample conf {elite_scores[0]:.4f}")

    calib_data_new = copy.deepcopy(calib_data)
    calib_data_new["stereo_extrinsic"]["rotation"] = apply_delta_rotation(
        calib_data["stereo_extrinsic"]["rotation"],
        euler_to_rotation_matrix(*best_params))
    return {"roll_delta": best_params[0], "pitch_delta": best_params[1],
            "yaw_delta": best_params[2],
            "initial_confidence": initial_confidence,
            "final_confidence": best_confidence,
            "calib_data_new": calib_data_new}
