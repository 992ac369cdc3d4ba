"""Stereo inference engine: weights, precision policy, padding, timing.

Numerics: on construction the engine turns off TF32 for cuDNN convolutions
and for matmuls (`torch.backends.cudnn.allow_tf32 = False`,
`torch.set_float32_matmul_precision("highest")`), process-wide. cuDNN's
default TF32 keeps about three decimal digits, which breaks the golden
tolerances of the fp32 engine and the fp32 islands of the bf16 engine.

Precisions: "fp32", "bf16", and the int8 engines "int8", "int8a" (only
128-aligned GEMMs quantized) and "int8r" (int8 plus the int8 residual
stream of the scanline blocks): a bf16 engine whose qualifying convs and
linears run as int8 sites (`models/quant.py`, kernel E on the card), with
static activation scales from a calibration pass (s2m2_tpu/runtime/
engine.py:95-276). An int8 engine calibrates on its first input or
raises; it never serves bf16 in place of int8. The JAX package's two int8
opt-ins are constructor arguments, fixed for the engine's life so that its
calibration and its inference agree (the JAX flags' calib_contract):
`int8_attn=True` runs the attention cores without PE in int8 (kernel F on
the card), `int8_acc_bf16=True` rounds every int8 GEMM's accumulator to
bf16 (kernel E's bf16-accumulator epilogue); both need an int8 precision.

Mesh (`mesh=parallel.mesh.make_mesh(...)`, the counterpart of the JAX
engine's `mesh` / `in_shardings`): SPMD, every rank calls `run` /
`forward_padded` with the same full inputs; the engine takes its shard
(pairs over 'data', bands of whole 32-row blocks over 'band'), runs the
forward under `parallel.band.sharded`, gathers, and returns the full maps on
every rank. An int8 engine calibrates on the full padded frames, unsharded,
on every rank, and checks that every rank's scales are the same. Without a
mesh nothing changes.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfig, Precision, get_config
from ..models import quant
from ..models.init import init_params
from ..models.s2m2 import S2M2
from ..parallel import band
from ..parallel.distributed import max_over_ranks
from ..parallel.mesh import all_reduce, band_rows, image_sharding, replicated
from ..tools.convert import load_checkpoint, tolerant_merge
from ..utils.image import image_crop, image_pad, read_images
from . import trace

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


PRECISIONS = ("fp32", "bf16", "int8", "int8a", "int8r")


class StereoEngine:
    """Owns the model on one device and runs padded inference.

    Usage:
        eng = StereoEngine("S", precision="bf16")            # on the card
        disp, occ, conf, score, ms = eng.run(left, right)    # HWC images

    `device` defaults to "cuda" (a mesh's device with a mesh) and the engine
    never drops to the CPU on its own: pass device="cpu" to run the plain
    PyTorch versions of the kernels. `mesh` shards every forward over its
    ranks (module docstring); its device must be the engine's.
    `fused_block=True` runs the MRT's scanline blocks with C, E <= 512 as one
    fused kernel each (kernel D); `self.model.set_fused_block` flips it.
    An int8 engine (`precision="int8" | "int8a" | "int8r"`) calibrates on
    its first input, or on `calibrate()` / `load_calibration()` beforehand;
    `int8_attn` and `int8_acc_bf16` are its opt-ins (module docstring).
    """

    def __init__(self, model_type_or_cfg="S", *, checkpoint: Optional[str] = None,
                 precision: str = "bf16", use_positivity: bool = True,
                 refine_iter: int = 3, seed: int = 0, device=None,
                 fused_block: bool = False, mesh=None, int8_attn: bool = False,
                 int8_acc_bf16: bool = False):
        if isinstance(model_type_or_cfg, ModelConfig):
            self.cfg = model_type_or_cfg
        else:
            self.cfg = get_config(model_type_or_cfg, use_positivity=use_positivity,
                                  refine_iter=refine_iter)
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.precision_name = precision
        self.quantize = precision.startswith("int8")
        if (int8_attn or int8_acc_bf16) and not self.quantize:
            raise ValueError(f"int8_attn and int8_acc_bf16 need an int8 precision, "
                             f"not {precision!r}")
        # the site policies and opt-ins of every quant context of this engine
        # (int8a: int8 only on 128-aligned GEMMs; int8r: int8 plus the int8
        # residual stream), per engine, so variants coexist in one process
        self.quant_policy = dict(aligned=precision == "int8a", skip_fp32=True,
                                 residency=precision == "int8r", attn=bool(int8_attn),
                                 acc_bf16=bool(int8_acc_bf16))
        self.quant_scales = None  # set by calibrate() / load_calibration()
        self.quant_gemms = 0      # quantized GEMMs the calibration pass saw
        self.mesh = mesh
        if device is None:
            device = "cuda" if mesh is None else mesh.device
        self.device = torch.device(device)
        if mesh is not None and torch.device(mesh.device) != self.device:
            raise ValueError(f"StereoEngine: the mesh is on {mesh.device}, the engine "
                             f"on {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StereoEngine: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

        self.precision = Precision.fp32() if precision == "fp32" else Precision.bf16()
        self.compute_dtype = self.precision.compute_dtype
        with trace.span("engine.init"):
            state = init_params(self.cfg, seed=seed)
            if checkpoint:
                state = tolerant_merge(state, load_checkpoint(checkpoint))
            model = S2M2(self.cfg, fused_block=fused_block)
            model.load_state_dict(state)
            keep = (fp32_keep_paths(self.cfg)
                    if self.precision.param_dtype != torch.float32 else ())
            cast_params(model, self.precision.param_dtype, keep)
            self.model = model.to(self.device).eval()
            if mesh is not None:
                replicated(mesh)(self.model)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _barrier(self):
        """Synchronize the device, then (with a mesh) every rank."""
        self._sync()
        if self.mesh is not None and self.mesh.world_group is not None:
            dist.barrier(group=self.mesh.world_group)

    def _images(self, img0, img1):
        """Both frames on the device in the compute dtype; counts the host
        bytes handed over under `bytes.h2d`."""
        with trace.span("run.upload"):
            host = [np.asarray(i, np.float32) for i in (img0, img1)]
            trace.count("bytes.h2d", sum(a.nbytes for a in host))
            return tuple(torch.as_tensor(a).to(self.device, self.compute_dtype) for a in host)

    def _forward(self, a, b):
        """The model on full device tensors, inside this engine's quant
        context; with a mesh, this rank's shard of them, gathered after."""
        if self.mesh is None or self.mesh.size == 1:
            return self._forward_local(a, b)
        h = a.shape[1]
        sharding = image_sharding(self.mesh)
        a, b = sharding.shard(a), sharding.shard(b)
        if self.mesh.n_band > 1:
            with band.sharded(self.mesh, band_rows(h, self.mesh.n_band)):
                out = self._forward_local(a, b)
        else:
            out = self._forward_local(a, b)
        full = sharding.gather(torch.cat([o.float() for o in out], dim=-1))
        return full[..., 0:1], full[..., 1:2], full[..., 2:3]

    def _forward_local(self, a, b):
        if not self.quantize:
            return self.model(a, b)
        if self.quant_scales is None:
            raise RuntimeError("int8 engine is not calibrated: call calibrate() or "
                               "load_calibration() (run() and forward_padded() "
                               "calibrate on their first input)")
        with quant.quantized(self.quant_scales, **self.quant_policy):
            return self.model(a, b)

    @torch.inference_mode()
    def calibrate(self, img0, img1, percentile=None):
        """Record each int8 site's max|x| on (already padded) frames and set
        the static scales amax / 127, the max over all calls so far; then
        prequantize the weights. percentile (e.g. 99.9): that percentile of
        |x| instead of the max. With a mesh every rank calibrates on the same
        full frames, unsharded, and the scales must agree on every rank (it
        raises if not). Returns the scales."""
        if not self.quantize:
            raise RuntimeError(f"calibrate(): a {self.precision_name} engine has no "
                               "int8 sites")
        quant.strip_model(self.model)  # observe runs on the float weights
        with quant.observe(percentile=percentile, **self.quant_policy) as obs:
            self.model(*self._images(img0, img1))
        if not obs:
            raise ValueError(
                "calibrate(): no quantizable GEMM sites in this model under the "
                "site policy (int8a with no 128-aligned channels?); use bf16")
        self.quant_gemms = sum(r["kind"] == "gemm_site" for r in quant.last_log())
        amax = torch.stack(obs).float().cpu().numpy()
        if self.quant_scales is not None:  # accumulate over calls
            if len(self.quant_scales) != len(amax):
                raise ValueError(f"calibrate(): {len(amax)} sites, but the engine's "
                                 f"scales have {len(self.quant_scales)}")
            amax = np.maximum(amax, self.quant_scales * np.float32(127.0))
        self.quant_scales = (amax / np.float32(127.0)).astype(np.float32)
        self._check_scales()
        self._prequantize()
        return self.quant_scales

    def _check_scales(self):
        """Raise unless every rank of the mesh holds these scales: one
        all-reduce of the max of (scales, -scales)."""
        m = self.mesh
        if m is None or m.world_group is None:
            return
        own = torch.as_tensor(self.quant_scales, dtype=torch.float64)
        hi, lo = all_reduce(m, torch.cat([own, -own]), m.world_group,
                            dist.ReduceOp.MAX).chunk(2)
        if not (torch.equal(hi, own) and torch.equal(-lo, own)):
            raise RuntimeError("calibrate(): the int8 scales differ between the mesh's "
                               f"ranks (largest gap {float((hi + lo).max())})")

    def _prequantize(self):
        quant.strip_model(self.model)
        quant.quantize_model(self.model, aligned=self.quant_policy["aligned"], skip_fp32=True)

    def save_calibration(self, path):
        """Save the int8 activation scales (.npy), as the JAX engine does."""
        if self.quant_scales is None:
            raise RuntimeError("nothing to save: the engine is not calibrated")
        np.save(path, self.quant_scales)

    def load_calibration(self, path):
        """Load scales from save_calibration (this port's or the JAX
        engine's, when the site counts agree) and prequantize the weights;
        the site count is checked when the next forward runs."""
        if not self.quantize:
            raise RuntimeError(f"load_calibration(): a {self.precision_name} engine has "
                               "no int8 sites")
        self.quant_scales = np.asarray(np.load(path), np.float32)
        self._prequantize()
        return self.quant_scales

    def _auto_calibrate(self, img0, img1, max_hw=512):
        """Calibrate on a copy of the frames decimated to at most max_hw px."""
        a = np.asarray(img0, np.float32)
        b = np.asarray(img1, np.float32)
        step = max(1, int(np.ceil(max(a.shape[1:3]) / max_hw)))
        self.calibrate(image_pad(a[:, ::step, ::step]), image_pad(b[:, ::step, ::step]))

    @staticmethod
    def _benchmark_calib_pair():
        """(left, right) float32 (1, H, W, 3) for calibrating synthetic-input
        benchmarks, as the JAX engine chooses them: S2M2_CALIB_PAIR=
        "left.png:right.png" names a real rectified pair (a missing file
        raises, never a silent fallback); unset, a deterministic synthetic
        scene (train.data._random_scene, seed 7), since uniform noise has no
        disparity structure and under-drives the matcher and refiners. Either
        way one warning line records the choice."""
        import logging
        import os
        log = logging.getLogger("s2m2_torch.engine")
        spec = os.environ.get("S2M2_CALIB_PAIR")
        if spec:
            lp, _, rp = spec.partition(":")
            if not (os.path.exists(lp) and os.path.exists(rp)):
                raise FileNotFoundError(f"S2M2_CALIB_PAIR points at missing files: {spec!r}")
            left, right = read_images(lp, rp)
            log.warning("int8 benchmark calibration pair: %s : %s", lp, rp)
            return np.asarray(left, np.float32)[None], np.asarray(right, np.float32)[None]
        log.warning("int8 benchmark calibration: built-in deterministic synthetic scene "
                    "(train.data._random_scene, seed 7); set "
                    "S2M2_CALIB_PAIR=left.png:right.png to calibrate on real data")
        from ..train.data import _random_scene
        left, right, _ = _random_scene(np.random.default_rng(7), 512, 608, max_disp=96)
        return left[None], right[None]

    @torch.inference_mode()
    def forward_padded(self, img0, img1):
        """Forward on already padded (B, H, W, 3) arrays; returns float32
        (disp, occ, conf) tensors of shape (B, H, W, 1) on the device. An
        uncalibrated int8 engine calibrates on these frames first."""
        if self.quantize and self.quant_scales is None:
            self._auto_calibrate(img0, img1)
        return tuple(o.float() for o in self._forward(*self._images(img0, img1)))

    def run(self, left, right, n_repeat: int = 1):
        """Full pipeline on HWC (or BHWC) images in [0, 255].

        Returns (disp, occ, conf, avg_conf_score, runtime_ms): numpy (H, W)
        (or (B, H, W)) maps at input resolution; avg_conf_score is the mean
        confidence over a 100 px-margin interior (the reference's
        self-calibration objective, model_utils.py:93-94). With n_repeat = 1,
        runtime_ms is the host time of the forward, ending in a device
        synchronize. With n_repeat > 1, one untimed warm forward runs first,
        then n_repeat forwards on the same padded pair, already on the
        device; runtime_ms is their mean, timed by CUDA events on the card
        (by the host clock on the CPU), and the maps are the last forward's
        (as s2m2_tpu/runtime/engine.py:325-373)."""
        if n_repeat < 1:
            raise ValueError(f"n_repeat must be >= 1, got {n_repeat}")
        with trace.span("engine.run") as root:
            with trace.span("run.prepare"):
                left = np.asarray(left, np.float32)
                right = np.asarray(right, np.float32)
                squeeze = left.ndim == 3
                if squeeze:
                    left, right = left[None], right[None]
                batch, h, w = left.shape[:3]
                root.set(batch=batch, h=h, w=w)
                lp, rp = image_pad(left), image_pad(right)
                if self.quantize and self.quant_scales is None:
                    self._auto_calibrate(lp, rp)  # set-up, outside the timed forward
            self._barrier()
            with trace.span("run.forward"):
                if n_repeat == 1:
                    t0 = time.perf_counter()
                    out = self.forward_padded(lp, rp)
                    self._sync()
                    runtime_ms = (time.perf_counter() - t0) * 1e3
                else:
                    out, runtime_ms = self._repeat_forward(lp, rp, n_repeat)
                if self.mesh is not None:  # the slowest rank's time
                    runtime_ms = max_over_ranks(self.mesh, runtime_ms)
            with trace.span("run.download"):
                maps = [o.cpu().numpy() for o in out]
                trace.count("bytes.d2h", sum(a.nbytes for a in maps))
            with trace.span("run.finish"):
                disp, occ, conf = (image_crop(a, (h, w))[..., 0] for a in maps)
                m = 100
                if h > 2 * m and w > 2 * m:
                    score = float(conf[:, m:-m, m:-m].mean())
                else:
                    score = float(conf.mean())
                if squeeze:
                    disp, occ, conf = disp[0], occ[0], conf[0]
        trace.count("run.pairs", batch)
        return disp, occ, conf, score, runtime_ms

    @torch.inference_mode()
    def _repeat_forward(self, lp, rp, n_repeat):
        """(float32 outputs of the last forward, mean ms per forward) of
        n_repeat forwards on one padded pair after one untimed forward."""
        a, b = self._images(lp, rp)
        self._forward(a, b)
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n_repeat):
                out = self._forward(a, b)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / n_repeat
        else:
            t0 = time.perf_counter()
            for _ in range(n_repeat):
                out = self._forward(a, b)
            ms = (time.perf_counter() - t0) * 1e3 / n_repeat
        return tuple(o.float() for o in out), ms

    def confidence_score(self, left, right) -> float:
        """The self-calibration objective (reference: model_utils.py:98-107)."""
        return self.run(left, right)[3]

    @torch.inference_mode()
    def benchmark(self, height, width, n_warmup=2, n_iter=10, batch=1):
        """Frames per second at a fixed (padded) resolution on synthetic
        inputs, timed with CUDA events around `n_iter` forwards. An
        uncalibrated int8 engine first calibrates on `_benchmark_calib_pair`."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark() times the card; this engine is on "
                               f"{self.device}")
        if self.quantize and self.quant_scales is None:
            self._auto_calibrate(*self._benchmark_calib_pair())
        g = torch.Generator(device=self.device).manual_seed(0)
        a, b = (torch.rand((batch, height, width, 3), generator=g,
                           device=self.device) * 255 for _ in range(2))
        a, b = a.to(self.compute_dtype), b.to(self.compute_dtype)
        for _ in range(n_warmup):
            self._forward(a, b)
        self._barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iter):
            self._forward(a, b)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / n_iter
        out = {}
        if self.mesh is not None:  # the mesh's rate: the slowest rank's time
            dt = max_over_ranks(self.mesh, dt)
            out = dict(mesh=list(self.mesh.shape), transport=self.mesh.transport)
        return dict(seconds_per_frame=dt / batch, fps=batch / dt,
                    height=height, width=width, batch=batch,
                    device=torch.cuda.get_device_name(self.device), **out)
