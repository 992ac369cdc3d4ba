"""Training checkpoints with `torch.save`, in the layout of
`s2m2_tpu/tools/checkpoint.py` (orbax):

    <dir>/<step>/params.pt      the model's state dict
    <dir>/<step>/opt_state.pt   the optimizer's state dict (when saved)
    <dir>/<step>/meta.json      a JSON object (when saved)

A step is written into `<dir>/<step>.tmp-<pid>` and renamed into place, as
orbax does, so a crash leaves no half-written step. The newest
`max_to_keep` steps are kept. Tensors are saved from wherever they live and
restored onto the CPU (`load_state_dict` moves them where they belong).
"""
from __future__ import annotations

import json
import os
import shutil

import torch


def _steps(directory):
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isdir(os.path.join(directory, n)))


def save_checkpoint(directory, step, params, opt_state=None, meta=None, max_to_keep=3):
    """Save a training state (state dicts of tensors); returns the step
    saved. Raises FileExistsError if the step is already there."""
    directory = os.path.abspath(directory)
    final = os.path.join(directory, str(int(step)))
    if os.path.exists(final):
        raise FileExistsError(f"checkpoint step {step} already exists under {directory}")
    tmp = f"{final}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(params, os.path.join(tmp, "params.pt"))
    if opt_state is not None:
        torch.save(opt_state, os.path.join(tmp, "opt_state.pt"))
    if meta is not None:
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
    os.replace(tmp, final)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))
    return step


def latest_step(directory):
    """The newest saved step, or None when there is none."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory, step=None, with_opt_state=False, with_meta=False):
    """Restore params[, opt_state][, meta] from the given or the latest step;
    raises FileNotFoundError when there is nothing to restore."""
    if step is None:
        step = latest_step(directory)
    path = None if step is None else os.path.join(directory, str(int(step)))
    if path is None or not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint {'' if step is None else step} "
                                f"under {directory}")

    def load(name):
        return torch.load(os.path.join(path, name), map_location="cpu", weights_only=True)

    result = [load("params.pt")]
    if with_opt_state:
        result.append(load("opt_state.pt"))
    if with_meta:
        with open(os.path.join(path, "meta.json")) as f:
            result.append(json.load(f))
    return result[0] if len(result) == 1 else tuple(result)
