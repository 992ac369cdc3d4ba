"""Stereo inference engine: weights, precision policy, padding, timing.

Numerics: on construction the engine turns off TF32 for cuDNN convolutions
and for matmuls (`torch.backends.cudnn.allow_tf32 = False`,
`torch.set_float32_matmul_precision("highest")`), process-wide. cuDNN's
default TF32 keeps about three decimal digits, which breaks the golden
tolerances of the fp32 engine and the fp32 islands of the bf16 engine.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import ModelConfig, Precision, get_config
from ..models.init import init_params
from ..models.s2m2 import S2M2
from ..tools.convert import load_checkpoint, tolerant_merge
from ..utils.image import image_crop, image_pad

# Subtrees whose weights stay float32 in a bf16 engine (fp32 islands, see
# s2m2_tpu/runtime/engine.py): the three c->1 / c->2 out-conv heads always,
# and the global refiner's UNet on the configs whose output scaling
# amplifies its weight noise (output_upsample, negative disparities).
FP32_HEAD_PATHS = (
    "refiner.disp_update.2",
    "refiner.conf_occ_update.2",
    "global_refiner.out_feat.0",
)


def fp32_keep_paths(cfg: ModelConfig):
    keep = FP32_HEAD_PATHS
    if cfg.output_upsample or not cfg.use_positivity:
        keep = keep + ("global_refiner.refine_unet",)
    return keep


def cast_params(model: torch.nn.Module, dtype, keep_fp32=()):
    """Cast every parameter to `dtype` in place, except those under a
    dotted-path prefix in `keep_fp32`, which stay float32."""
    for name, p in model.named_parameters():
        keep = any(name == k or name.startswith(k + ".") for k in keep_fp32)
        p.data = p.data.to(torch.float32 if keep else dtype)
    return model


class StereoEngine:
    """Owns the model on one device and runs padded inference.

    Usage:
        eng = StereoEngine("S", precision="bf16")            # on the card
        disp, occ, conf, score, ms = eng.run(left, right)    # HWC images

    `device` defaults to "cuda" and the engine never drops to the CPU on its
    own: pass device="cpu" to run the plain PyTorch versions of the kernels.
    `fused_block=True` runs the MRT's scanline blocks with C, E <= 512 as one
    fused kernel each (kernel D); `self.model.set_fused_block` flips it.
    """

    def __init__(self, model_type_or_cfg="S", *, checkpoint: Optional[str] = None,
                 precision: str = "bf16", use_positivity: bool = True,
                 refine_iter: int = 3, seed: int = 0, device="cuda",
                 fused_block: bool = False):
        if isinstance(model_type_or_cfg, ModelConfig):
            self.cfg = model_type_or_cfg
        else:
            self.cfg = get_config(model_type_or_cfg, use_positivity=use_positivity,
                                  refine_iter=refine_iter)
        if precision.startswith("int8"):
            raise NotImplementedError(
                f"precision {precision!r}: int8 is a later slice of the port "
                "(ROADMAP.md, Queue 1 item 8); use 'fp32' or 'bf16'")
        if precision not in ("fp32", "bf16"):
            raise ValueError(f"precision must be 'fp32' or 'bf16', got {precision!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StereoEngine: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

        self.precision = Precision.bf16() if precision == "bf16" else Precision.fp32()
        self.compute_dtype = self.precision.compute_dtype
        state = init_params(self.cfg, seed=seed)
        if checkpoint:
            state = tolerant_merge(state, load_checkpoint(checkpoint))
        model = S2M2(self.cfg, fused_block=fused_block)
        model.load_state_dict(state)
        keep = (fp32_keep_paths(self.cfg)
                if self.precision.param_dtype != torch.float32 else ())
        cast_params(model, self.precision.param_dtype, keep)
        self.model = model.to(self.device).eval()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def forward_padded(self, img0, img1):
        """Forward on already padded (B, H, W, 3) arrays; returns float32
        (disp, occ, conf) tensors of shape (B, H, W, 1) on the device."""
        a = torch.as_tensor(np.asarray(img0, np.float32)).to(self.device,
                                                             self.compute_dtype)
        b = torch.as_tensor(np.asarray(img1, np.float32)).to(self.device,
                                                             self.compute_dtype)
        return tuple(o.float() for o in self.model(a, b))

    def run(self, left, right):
        """Full pipeline on HWC (or BHWC) images in [0, 255].

        Returns (disp, occ, conf, avg_conf_score, runtime_ms): numpy (H, W)
        (or (B, H, W)) maps at input resolution; avg_conf_score is the mean
        confidence over a 100 px-margin interior (the reference's
        self-calibration objective, model_utils.py:93-94); runtime_ms is the
        host time of the forward, ending in a device synchronize."""
        left = np.asarray(left, np.float32)
        right = np.asarray(right, np.float32)
        squeeze = left.ndim == 3
        if squeeze:
            left, right = left[None], right[None]
        h, w = left.shape[1:3]
        lp, rp = image_pad(left), image_pad(right)
        self._sync()
        t0 = time.perf_counter()
        out = self.forward_padded(lp, rp)
        self._sync()
        runtime_ms = (time.perf_counter() - t0) * 1e3
        disp, occ, conf = (image_crop(o.cpu().numpy(), (h, w))[..., 0] for o in out)
        m = 100
        if h > 2 * m and w > 2 * m:
            score = float(conf[:, m:-m, m:-m].mean())
        else:
            score = float(conf.mean())
        if squeeze:
            disp, occ, conf = disp[0], occ[0], conf[0]
        return disp, occ, conf, score, runtime_ms

    def confidence_score(self, left, right) -> float:
        """The self-calibration objective (reference: model_utils.py:98-107)."""
        return self.run(left, right)[3]

    @torch.inference_mode()
    def benchmark(self, height, width, n_warmup=2, n_iter=10, batch=1):
        """Frames per second at a fixed (padded) resolution on synthetic
        inputs, timed with CUDA events around `n_iter` forwards."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark() times the card; this engine is on "
                               f"{self.device}")
        g = torch.Generator(device=self.device).manual_seed(0)
        a, b = (torch.rand((batch, height, width, 3), generator=g,
                           device=self.device) * 255 for _ in range(2))
        a, b = a.to(self.compute_dtype), b.to(self.compute_dtype)
        for _ in range(n_warmup):
            self.model(a, b)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iter):
            self.model(a, b)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / n_iter
        return dict(seconds_per_frame=dt / batch, fps=batch / dt,
                    height=height, width=width, batch=batch,
                    device=torch.cuda.get_device_name(self.device))
