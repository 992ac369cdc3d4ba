"""The training loop: data -> train step -> metrics and checkpoints, from
`s2m2_tpu/train/trainer.py`, on one device or data-parallel over a mesh.

    model, optimizer, history = train(cfg, batches, num_steps=1000,
                                      compute_dtype=torch.bfloat16)

The model is the port's own `S2M2` module built on `device` (the inference
engine runs under `inference_mode` and is not for training), with its
parameters as the fp32 masters; the fused block stays off, so every
scanline block runs through kernels A and B on the card.

With `mesh` (`parallel.mesh.make_mesh(n_data, n_band, ...)`, every rank
running `train` on the same stream of batches) each rank trains on its
shard of every batch: its data slice and, with n_band > 1, its band of
rows, whole 32-row blocks (train/step.py); all ranks take the same step,
and only global rank 0 logs and writes checkpoints.
"""
from __future__ import annotations

import time

import torch

from ..config import ModelConfig
from ..models.init import init_params
from ..models.s2m2 import S2M2
from .step import make_optimizer, make_train_step


def train(cfg: ModelConfig, batches, *, num_steps=100, lr=1e-4, seed=0,
          checkpoint_dir=None, checkpoint_every=500, log_every=10, params=None,
          log=print, warmup_steps=0, compute_dtype=None, device=None, mesh=None):
    """Run `num_steps` optimizer steps over `batches` (an iterator of batch
    dicts of NHWC float32 arrays or tensors).

    warmup_steps > 0 enables the linear-warmup + cosine-decay LR schedule
    over num_steps. Supervision is RAFT-style sequence loss
    (train/loss.py::sequence_loss). compute_dtype=torch.bfloat16 runs the
    forward on bf16 copies of the fp32 masters (train/step.py). `params`, a
    state dict, replaces the seeded init. A history record (loss terms,
    epe, step, sec since the start) is kept every `log_every` steps and at
    the last; checkpoints (tools/checkpoint.py) are written at every
    `checkpoint_every`-th step after step 0 and at `num_steps` at the end.
    `device` defaults to "cuda" (the mesh's device with a mesh).
    Returns (model, optimizer, history)."""
    if device is None:
        device = "cuda" if mesh is None else mesh.device
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: CUDA is not available; pass device='cpu' to train "
                           "on the CPU")
    model = S2M2(cfg)
    model.load_state_dict(init_params(cfg, seed=seed) if params is None else params)
    model = model.to(device).train()
    optimizer = make_optimizer(lr=lr, warmup_steps=warmup_steps, total_steps=num_steps)
    train_step = make_train_step(cfg, model, optimizer, compute_dtype=compute_dtype,
                                 mesh=mesh)
    lead = mesh is None or mesh.rank == 0

    history = []
    t0 = time.perf_counter()
    for step, batch in enumerate(batches):
        if step >= num_steps:
            break
        metrics = train_step(batch)
        if step % log_every == 0 or step == num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["sec"] = time.perf_counter() - t0
            history.append(m)
            if lead:
                log(f"step {step}: loss={m['loss']:.4f} epe={m['epe']:.3f}")
        if lead and checkpoint_dir and step and step % checkpoint_every == 0:
            _save(checkpoint_dir, step, model, optimizer)
    if lead and checkpoint_dir:
        _save(checkpoint_dir, num_steps, model, optimizer)
    return model, optimizer, history


def _save(directory, step, model, optimizer):
    from ..tools.checkpoint import save_checkpoint
    save_checkpoint(directory, step, model.state_dict(), optimizer.state_dict(),
                    meta={"step": step})
