"""Training convergence on synthetic stereo: does the port's training learn?
A port of scripts/train_convergence.py with the same settings, data and
evaluation, on the card unless `--device cpu` is given.

    python -m s2m2_torch.tools.train_convergence [--steps 400] [--bf16]
        [--eval-every 50] [--no-augment] [--out train_convergence_torch.json]
        [--save-ckpt trained.npz] [--device cuda]

CH32 / NTR1 / refine_iter 2 at 96x128, max_disp 16, batch 2, AdamW at lr 4e-4
under a warmup (max(steps // 20, 1) steps) + cosine schedule, sequence loss;
`--bf16` runs the forward on bf16 copies of the fp32 masters. Training data
is `synthetic_stereo_batches` seed 0 through `augment_batches` seed 1; the
held-out set is 4 scenes of seed 9999. Held-out EPE and bad-2.0 come from
the fp32 inference forward with no grad (float32 on the card means TF32
off), at step 0, every `--eval-every` steps and at the last. The record
nests one run per policy ({"fp32": ..., "bf16": ...}) in `--out`, with the
ms per step (CUDA events around each step on the card, the host clock on
the CPU), the device's name and power limit, and the torch version; it
never writes train_convergence.json, the JAX package's record.
`--save-ckpt` writes the final parameters as a JAX-layout npz (the layout
of tests/golden/trained_c32.npz).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

JAX_RECORD = "train_convergence.json"


def make_eval_set(n=4, height=96, width=128, max_disp=16, seed=9999):
    """Held-out scenes from a seed the training stream never uses."""
    from ..train.data import synthetic_stereo_batches
    return list(synthetic_stereo_batches(batch=1, height=height, width=width,
                                         max_disp=max_disp, seed=seed, n_batches=n))


def train_batches(batch=2, height=96, width=128, max_disp=16, augment=True):
    """The training stream: data seed 0, augmentation seed 1."""
    from ..train.augment import augment_batches
    from ..train.data import synthetic_stereo_batches
    batches = synthetic_stereo_batches(batch=batch, height=height, width=width,
                                       max_disp=max_disp, seed=0)
    return augment_batches(batches, seed=1) if augment else batches


def make_optimizer(steps, lr):
    """AdamW under the warmup + cosine schedule of a `steps`-step run."""
    from ..train.step import make_optimizer as make
    return make(lr=lr, warmup_steps=max(steps // 20, 1), total_steps=steps)


def evaluate(model, eval_set):
    """(mean held-out EPE, mean bad-2.0) of `model`'s fp32 inference
    forward on `eval_set`."""
    import torch
    from ..utils import metrics
    device = next(model.parameters()).device
    epes, bads = [], []
    with torch.no_grad():
        for s in eval_set:
            a, b = (torch.from_numpy(s[k]).to(device) for k in ("img0", "img1"))
            d = model(a, b)[0].float().cpu().numpy()[..., 0]
            gt = s["gt_disp"][..., 0]
            valid = s["valid"][..., 0] > 0
            epes.append(metrics.epe(d, gt, valid))
            bads.append(metrics.bad_ratio(d, gt, 2.0, valid))
    return float(np.mean(epes)), float(np.mean(bads))


def _device_record(device):
    import torch
    rec = {"device": device.type, "torch": torch.__version__}
    if device.type == "cuda":
        from .bench import card_name_and_power
        index = device.index or 0
        rec["name"], rec["power_limit_w"] = card_name_and_power(index)
    return rec


def run(args, log=print):
    """Train and evaluate as `args` says; returns the run's record."""
    import torch
    from ..config import ModelConfig
    from ..models.init import init_params
    from ..models.s2m2 import S2M2
    from ..train.step import make_train_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_convergence: CUDA is not available; pass --device cpu")
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cfg = ModelConfig(feature_channels=args.ch, num_transformer=1,
                      refine_iter=args.refine_iter)
    model = S2M2(cfg)
    model.load_state_dict(init_params(cfg, seed=0))
    model = model.to(device).train()
    eval_set = make_eval_set(height=args.height, width=args.width, max_disp=args.max_disp)
    e0, b0 = evaluate(model, eval_set)
    log(f"init (random params): held-out EPE {e0:.3f} px  bad-2.0 {b0:.3f}")

    optimizer = make_optimizer(args.steps, args.lr)
    train_step = make_train_step(cfg, model, optimizer,
                                 compute_dtype=torch.bfloat16 if args.bf16 else None)
    batches = train_batches(args.batch, args.height, args.width, args.max_disp,
                            augment=not args.no_augment)
    cuda = device.type == "cuda"
    history = [{"step": 0, "epe": e0, "bad2": b0}]
    step_ms, finite = [], True
    t0 = time.perf_counter()
    for step, batch in enumerate(batches, start=1):
        if step > args.steps:
            break
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            m = train_step(batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        else:
            ts = time.perf_counter()
            m = train_step(batch)
            step_ms.append((time.perf_counter() - ts) * 1e3)
        loss = float(m["loss"])
        finite = finite and math.isfinite(loss)
        if step % args.eval_every == 0 or step == args.steps:
            e, b = evaluate(model, eval_set)
            rec = {"step": step, "loss": loss, "train_epe": float(m["epe"]), "epe": e,
                   "bad2": b, "sec": round(time.perf_counter() - t0, 1)}
            history.append(rec)
            log(f"step {step}: loss={rec['loss']:.3f} train_epe={rec['train_epe']:.3f} "
                f"held-out EPE={e:.3f} bad2={b:.3f} ({rec['sec']:.0f}s)")
    wall = time.perf_counter() - t0

    if args.save_ckpt:
        from .convert import to_jax
        np.savez(args.save_ckpt, **to_jax(model.state_dict()))
        log(f"saved trained checkpoint -> {args.save_ckpt}")
    return {
        "config": {"ch": args.ch, "ntr": 1, "refine_iter": args.refine_iter,
                   "hw": [args.height, args.width], "max_disp": args.max_disp,
                   "batch": args.batch, "steps": args.steps, "lr": args.lr,
                   "bf16": args.bf16, "augment": not args.no_augment},
        "init_epe": e0, "final_epe": history[-1]["epe"],
        "init_bad2": b0, "final_bad2": history[-1]["bad2"],
        "all_losses_finite": finite,
        "ms_per_step_median": float(np.median(step_ms)) if step_ms else None,
        "ms_per_step_mean": float(np.mean(step_ms)) if step_ms else None,
        "step_timer": "CUDA events" if cuda else "host clock",
        "wall_s": wall, **_device_record(device),
        "history": history,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--ch", type=int, default=32)
    ap.add_argument("--refine-iter", type=int, default=2)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--max-disp", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 forward over fp32 masters")
    ap.add_argument("--no-augment", action="store_true")
    ap.add_argument("--out", default="train_convergence_torch.json")
    ap.add_argument("--save-ckpt", default=None,
                    help="save the final parameters as a JAX-layout npz")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if os.path.basename(args.out) == JAX_RECORD:
        ap.error(f"--out: {JAX_RECORD} is the JAX package's record; write another file")

    result = run(args, log=lambda msg: print(msg, flush=True))
    key = "bf16" if args.bf16 else "fp32"
    existing = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    existing[key] = result
    with open(args.out, "w") as f:
        json.dump(existing, f, indent=1)
    print(f"wrote {args.out} [{key}]: EPE {result['init_epe']:.2f} -> "
          f"{result['final_epe']:.2f} px (bad-2.0 {result['init_bad2']:.2f} -> "
          f"{result['final_bad2']:.2f}), {result['ms_per_step_median']:.1f} ms/step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
