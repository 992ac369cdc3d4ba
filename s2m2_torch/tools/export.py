"""Serving artifacts: the S2M2 forward as a `torch.export` program (.pt2).

The port's counterpart of `s2m2_tpu/tools/export.py`, function for
function, and like it the analog of the reference's ONNX / TensorRT path
(src/s2m2/tools/export_model.py, demo/export_tensorrt.py): one artifact per
(variant, height, width, precision), static shapes, loadable and runnable
without the model's source.

The program is traced with `torch.export` under `torch.no_grad()`. Kernels
A-E are `torch.library` custom ops (`s2m2_torch/ops/library.py`) that the
wrappers call while export traces, so the program holds one
`torch.ops.s2m2_torch.*` call per kernel launch and, run on the card,
launches the hand-written kernels (run on the CPU, their plain versions).
Loading a program needs `s2m2_torch.ops.library` imported (this module
does it) and nothing of `s2m2_torch.models`.

A program traced on the card holds the card's device in its graph and, for
`export_forward`, CUDA weights; `load_artifact(path, device)` moves both to
`device` explicitly (`torch.export.passes.move_to_device_pass`). Loading on
the card is the default and raises without one. Every entry point traces on
the card unless it is asked for the CPU (`device="cpu"`); a program traced
on either device holds the same custom-op calls.
"""
from __future__ import annotations

import io
import os
from collections.abc import Mapping

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import library  # noqa: F401  (registers the kernels' custom ops)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to export or load "
                           "on the CPU")
    return device


def _images(batch, height, width, device):
    """Example inputs: float32 NHWC (batch, height, width, 3) pairs."""
    img = torch.zeros((batch, height, width, 3), dtype=torch.float32, device=device)
    return img, img.clone()


def _outputs(disp, occ, conf):
    return disp.float(), occ.float(), conf.float()


def _model(cfg, fused_block, state, dtype, device):
    """A fresh S2M2 on `device` with `state` loaded and EVERY parameter cast
    to `dtype` (None: the model's own random parameters stay unloaded)."""
    from ..models.s2m2 import S2M2
    model = S2M2(cfg, fused_block=fused_block)
    if state is not None:
        model.load_state_dict(state)
    return model.to(device=device, dtype=dtype).eval()


class _Forward(nn.Module):
    """float32 NHWC images in, float32 (disp, occ, conf) out, the model run
    in `dtype`; the model's parameters are the program's."""

    def __init__(self, model, dtype):
        super().__init__()
        self.model = model
        self.dtype = dtype

    def forward(self, img0, img1):
        return _outputs(*self.model(img0.to(self.dtype), img1.to(self.dtype)))


class _Functional(nn.Module):
    """(state, img0, img1) -> float32 (disp, occ, conf): `model` run through
    torch.func.functional_call on the state it is given, inside `context()`
    (a quant context for the int8 programs). The model is held outside the
    module tree, so none of its tensors enter the program."""

    def __init__(self, model, dtype, context=None):
        super().__init__()
        self._model = (model,)
        self.dtype = dtype
        self.context = context

    def forward(self, state, img0, img1):
        args = (img0.to(self.dtype), img1.to(self.dtype))
        if self.context is None:
            return _outputs(*torch.func.functional_call(self._model[0], state, args))
        with self.context():
            return _outputs(*torch.func.functional_call(self._model[0], state, args))


def _trace(module, args):
    with torch.no_grad():
        return torch.export.export(module, args, strict=False)


def _serialize(program) -> bytes:
    """The program's .pt2 bytes, without its example inputs (a weight-free
    program's would be a state dict of zeros as large as the weights)."""
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _state_of(model_or_state):
    if isinstance(model_or_state, nn.Module):
        return model_or_state.state_dict()
    return model_or_state


def _forward_program(model_or_state, cfg, height, width, batch, compute_dtype, device,
                     fused_block):
    device = _device(device)
    model = _model(cfg, fused_block, _state_of(model_or_state), compute_dtype, device)
    return _trace(_Forward(model, compute_dtype), _images(batch, height, width, device))


def export_forward(model_or_state, cfg: ModelConfig, height: int, width: int,
                   batch: int = 1, compute_dtype=torch.bfloat16, device="cuda",
                   fused_block: bool = False) -> bytes:
    """The forward at a static shape with its weights embedded: returns the
    bytes of a .pt2 program taking float32 NHWC (batch, height, width, 3)
    images and returning float32 (disp, occ, conf).

    `model_or_state` is an S2M2 (its state dict is taken; the module itself
    is left as it is) or a state dict. Like the JAX export, EVERY parameter
    is cast to `compute_dtype`: this is not the engine's policy, which keeps
    the fp32 islands (runtime/engine.py `fp32_keep_paths`) in a bf16 engine.
    `fused_block` routes the scanline blocks with C, E <= 512 to kernel D."""
    return _serialize(_forward_program(model_or_state, cfg, height, width, batch,
                                       compute_dtype, device, fused_block))


def export_program_text(model_or_state, cfg: ModelConfig, height: int, width: int,
                        batch: int = 1, compute_dtype=torch.bfloat16, device="cuda",
                        fused_block: bool = False) -> str:
    """The counterpart of the JAX package's `export_stablehlo_mlir`: the
    exported program of `export_forward` as text, its ATen-IR graph with the
    static entry shapes (e.g. `f32[1, 32, 64, 3]`) and the kernels'
    `torch.ops.s2m2_torch.*` calls. There is no StableHLO here (no XLA), and
    no ONNX (`onnx` and `onnxscript` are not installed, and the kernels
    would be opaque custom nodes to an ONNX runtime): the .pt2 program is
    the interchange format, and this text is its readable form."""
    return str(_forward_program(model_or_state, cfg, height, width, batch, compute_dtype,
                                device, fused_block))


def export_forward_with_weights(cfg: ModelConfig, height: int, width: int,
                                batch: int = 1, compute_dtype=torch.bfloat16,
                                device="cuda", fused_block: bool = False) -> bytes:
    """A weight-free program: it takes (state, img0, img1), `state` a state
    dict of the model in `compute_dtype` on the program's device (e.g.
    `{k: v.to(device, compute_dtype) for k, v in init_params(cfg).items()}`),
    and returns float32 (disp, occ, conf). It holds program text and no
    tensors, a few MB even at XL, whose bf16 weights are 812 MB. The model is
    traced on the meta device's parameters, so `device="meta"` traces it
    without memory."""
    device = torch.device(device) if str(device) == "meta" else _device(device)
    with torch.device("meta"):
        model = _model(cfg, fused_block, None, compute_dtype, "meta")
    state = {k: torch.zeros(v.shape, dtype=compute_dtype, device=device)
             for k, v in model.state_dict().items()}
    program = _trace(_Functional(model, compute_dtype),
                     (state, *_images(batch, height, width, device)))
    return _serialize(program)


def quantized_state(engine) -> dict:
    """The arguments an `export_quantized_forward` program takes besides
    the images: every parameter and buffer of the engine's model, the
    prequantized int8 weights (`w_q`, `w_scale`, `w_q_taps`, non-persistent
    buffers set by calibration) and the float weights the int8 forward
    still reads, in the engine's dtypes, on its device."""
    return {**dict(engine.model.named_parameters()), **dict(engine.model.named_buffers())}


def export_quantized_forward(engine, height: int, width: int, batch: int = 1) -> bytes:
    """A CALIBRATED int8 / int8a / int8r engine's forward, the analog of the
    reference's int8 TensorRT engine: the static per-site scales are baked
    into the program as constants, the prequantized weights are its
    arguments (`quantized_state(engine)`), so it stays weight-free. Traced
    on the engine's device. The program takes (state, img0, img1) with
    float32 NHWC images and returns float32 (disp, occ, conf). Raises
    ValueError for an engine that is not a calibrated int8 one."""
    if not getattr(engine, "quantize", False) or engine.quant_scales is None:
        raise ValueError("export_quantized_forward needs a calibrated "
                         "int8/int8a/int8r StereoEngine")
    from ..models import quant
    scales = [float(s) for s in engine.quant_scales]

    def context():
        return quant.quantized(scales, **engine.quant_policy)

    program = _trace(_Functional(engine.model, engine.compute_dtype, context),
                     (quantized_state(engine), *_images(batch, height, width,
                                                        engine.device)))
    return _serialize(program)


def save_artifact(path: str, blob: bytes):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)


class Artifact:
    """A loaded program (`program`, a torch.export.ExportedProgram on its
    device); calling it runs the program under inference_mode with the
    arguments it was exported with: (img0, img1), or (state, img0, img1). A
    state may be any mapping (`state_dict()` gives an OrderedDict): it is
    passed on as the plain dict the program was traced with."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()

    def __call__(self, *args):
        args = tuple(dict(a) if isinstance(a, Mapping) else a for a in args)
        with torch.inference_mode():
            return self._module(*args)


def load_artifact(path: str, device="cuda") -> Artifact:
    """Load a .pt2 program onto `device` ("cuda" by default; raises with no
    card unless device="cpu" is passed): its weights and the device
    arguments of its graph are moved there explicitly."""
    from torch.export.passes import move_to_device_pass
    device = _device(device)
    return Artifact(move_to_device_pass(torch.export.load(path), str(device)))


def artifact_name(cfg: ModelConfig, height: int, width: int,
                  precision: str = "bf16") -> str:
    return (f"s2m2_CH{cfg.feature_channels}NTR{cfg.num_transformer}"
            f"_{width}x{height}_{precision}.pt2")
