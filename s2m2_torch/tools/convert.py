"""Weights between the JAX package's layouts and torch state dicts.

  Conv2d weight           (kh, kw, I, O) <-> (O, I, kh, kw)
  ConvTranspose2d weight  (kh, kw, I, O) <-> (I, O, kh, kw)
  Linear weight           (I, O)         <-> (O, I)
  norm weight/bias        (C,)           unchanged

Key names are the reference's dotted state-dict names in both layouts, so a
reference `CH*NTR*.pth` state dict loads into the port with no renaming, and
a JAX-layout `.npz` (the golden fixtures, `s2m2_tpu.tools.convert_checkpoint`
output) loads through `from_jax`.
"""
from __future__ import annotations

import numpy as np
import torch

# torch ConvTranspose2d module paths inside S2M2 (weight layout (I,O,kh,kw))
_TRANSPOSED_CONV_KEYS = (
    "upsample_mask_1x.conv_disp.0",
    "upsample_mask_1x.conv_rgb.0",
    "upsample_mask_1x.conv_ctx",
    "upsample_mask_1x.conv_concat.2",
    "upsample_mask_4x_refine.conv_x",
    "upsample_mask_4x_refine.conv_concat.2",
)


def _is_transposed(name: str) -> bool:
    mod = name[: -len(".weight")]
    return any(mod == k or mod.endswith("." + k) for k in _TRANSPOSED_CONV_KEYS)


def _perm(name: str, ndim: int, to_torch: bool):
    if not name.endswith(".weight") or ndim not in (2, 4):
        return None
    if ndim == 2:
        return (1, 0)
    if _is_transposed(name):
        return (2, 3, 0, 1)  # (kh,kw,I,O) <-> (I,O,kh,kw): its own inverse
    return (3, 2, 0, 1) if to_torch else (2, 3, 1, 0)


def from_jax(flat: dict) -> dict:
    """{dotted name: JAX-layout array} -> torch state dict (float32, CPU)."""
    out = {}
    for name, arr in flat.items():
        a = np.asarray(arr, np.float32)
        p = _perm(name, a.ndim, to_torch=True)
        # np.array copies: the input may be a read-only view (a JAX array)
        out[name] = torch.from_numpy(np.array(a if p is None else np.transpose(a, p),
                                              order="C"))
    return out


def to_jax(state_dict: dict) -> dict:
    """torch state dict -> {dotted name: JAX-layout float32 ndarray}."""
    out = {}
    for name, t in state_dict.items():
        a = t.detach().float().cpu().numpy()
        p = _perm(name, a.ndim, to_torch=False)
        out[name] = np.ascontiguousarray(a if p is None else np.transpose(a, p))
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {dotted.name: leaf}."""
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten(v, name))
        else:
            flat[name] = v
    return flat


def load_npz(path: str) -> dict:
    """A JAX-layout `.npz` checkpoint as a torch state dict. Entries whose
    names start with `__` (fixture inputs and metadata) are left out."""
    with np.load(path) as z:
        return from_jax({k: z[k] for k in z.files if not k.startswith("__")})


def load_checkpoint(path: str) -> dict:
    """A reference `.pth` (torch layout) or a JAX-layout `.npz` checkpoint as
    a torch state dict."""
    if str(path).endswith(".pth"):
        ckpt = torch.load(path, weights_only=True, map_location="cpu")
        return dict(ckpt.get("state_dict", ckpt))
    return load_npz(path)


def tolerant_merge(template: dict, loaded: dict) -> dict:
    """Take `loaded`'s tensors over `template`'s where the names and shapes
    agree; skip the others with a message (reference: s2m2.py:69-78,
    strict=False semantics)."""
    merged = dict(template)
    for name, t in loaded.items():
        if name not in template:
            print(f"Skip unexpected parameter: {name}")
            continue
        if tuple(t.shape) != tuple(template[name].shape):
            print(f"Skip loading parameter: {name}, required shape: "
                  f"{tuple(template[name].shape)}, loaded shape: {tuple(t.shape)}")
            continue
        merged[name] = t
    missing = set(template) - set(loaded)
    if missing:
        print(f"{len(missing)} parameters not in checkpoint (kept initialized)")
    return merged
