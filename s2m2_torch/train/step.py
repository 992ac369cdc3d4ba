"""One training step: the loss's gradient and an AdamW update, from
`s2m2_tpu/train/step.py`.

`make_optimizer` is optax's `chain(clip_by_global_norm(clip), adamw(lr,
weight_decay))`, optionally under `warmup_cosine_decay_schedule(0, lr,
warmup, total, lr * 0.01)`, written out on a dict of tensors in optax's
arithmetic order:

- the clip scales by `(g / norm) * clip` only when norm >= clip (torch's
  `clip_grad_norm_` would scale by clip / (norm + 1e-6) always);
- the schedule is read at the step count before its increment, so with a
  warmup the first update moves nothing, not even the weight decay;
- the weight decay, `weight_decay * p` added to the Adam direction before
  the learning rate scales it, applies to every parameter.

`make_train_step` differentiates the port's `S2M2` at its own parameters
(fp32 masters). With `compute_dtype=torch.bfloat16` the forward runs on
bf16 copies made inside the differentiated function
(`torch.func.functional_call`), so the masters receive float32 gradients,
as the JAX step casts params inside `loss_fn` (not `autocast`, which keeps
other ops in float32 than the JAX policy does). On the card the kernels
A, B and C run in the forward and their backward recomputes their plain
versions (ops/_grad.py); the fused block (D) and the int8 sites (E) raise
under grad.

Over a mesh (`mesh`, n_data x n_band): each rank takes its data slice of
the batch and, with n_band > 1, its band's rows of every image and map
(`shard_batch`, whole 32-row blocks by `mesh.band_rows`), and runs the
forward as that band (`parallel.band.sharded`), whose collectives carry
their gradients back (parallel/band.py). The loss normalises by the batch's
supervised pixels, so the ranks first sum their counts over the world
group, band and data together (`loss.valid_counts`; each band holds whole
32-row blocks, so the quarter-grid counts are row-local): each rank's loss
is then its share of the whole batch's. The gradients and the metrics are
summed over the world group the same way, so the clip sees the global
gradient norm and every rank takes the same step. Each rank runs the 1/32
global blocks on the gathered map, so its gradients of their parameters
are partial; the sum completes them as it does every other parameter's.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.func import functional_call

from ..parallel import band
from ..parallel.mesh import all_reduce, band_rows, data_slice, image_sharding, replicated
from .loss import sequence_loss, valid_counts

BATCH_KEYS = ("img0", "img1", "gt_disp", "valid", "gt_nonocc")
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


def warmup_cosine_decay(peak, warmup_steps, total_steps, end):
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps, total_steps,
    end) as a function of the step count, in float32 and optax's order of
    operations: a linear ramp from 0, then a cosine decay to `end`."""
    f32 = np.float32
    alpha = 0.0 if peak == 0 else end / peak
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"total_steps ({total_steps}) must exceed warmup_steps "
                         f"({warmup_steps})")

    def schedule(count):
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return float(f32(-peak) * frac + f32(peak))
        c = f32(min(count - warmup_steps, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay_steps)))
        return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))
    return schedule


class AdamW:
    """optax's chain(clip_by_global_norm(clip), adamw(lr, weight_decay)) on
    a dict of parameters, updated in place. `lr` is a float or a function of
    the step count. The state (`count`, first and second moments `mu`, `nu`
    by parameter name) is made by `init` and kept by `state_dict` /
    `load_state_dict`."""

    def __init__(self, lr, weight_decay=1e-5, clip=1.0):
        self.lr, self.weight_decay, self.clip = lr, weight_decay, clip
        self.state = None

    def lr_at(self, count):
        """The learning rate of the update made at step `count` (0 first)."""
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def init(self, params):
        self.state = {"count": 0,
                      "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                      "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def state_dict(self):
        return {"count": self.state["count"], "mu": dict(self.state["mu"]),
                "nu": dict(self.state["nu"])}

    def load_state_dict(self, state):
        """Take a `state_dict()` (e.g. restored from a checkpoint), its
        tensors moved to the current moments' devices."""
        if self.state is None:
            raise RuntimeError("load_state_dict: init(params) first")
        for key in ("mu", "nu"):
            mine = self.state[key]
            if set(state[key]) != set(mine):
                raise ValueError(f"optimizer state {key!r} does not match the parameters")
            self.state[key] = {k: state[key][k].to(mine[k].device, mine[k].dtype)
                               for k in mine}
        self.state["count"] = int(state["count"])

    @torch.no_grad()
    def update(self, params, grads):
        """One step on `params` (name -> tensor, in place) from `grads` (name
        -> tensor, left unchanged)."""
        names = list(params)
        p = [params[k] for k in names]
        mu = [self.state["mu"][k] for k in names]
        nu = [self.state["nu"][k] for k in names]
        g = [grads[k] for k in names]
        count = self.state["count"]
        # clip_by_global_norm: (g / norm) * clip where norm >= clip
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        below = norm < self.clip
        g = torch._foreach_div(g, torch.where(below, 1.0, norm))
        torch._foreach_mul_(g, torch.where(below, 1.0, torch.tensor(self.clip, device=norm.device)))
        # scale_by_adam: mu, nu updated as (1 - b) * g**k + b * m
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - B1))
        torch._foreach_mul_(nu, B2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - B2))
        # bias corrections 1 - b**t in float32, as optax takes them
        t = np.float32(count + 1)
        bc1 = float(np.float32(1) - np.float32(B1) ** t)
        bc2 = float(np.float32(1) - np.float32(B2) ** t)
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, EPS)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        # add_decayed_weights, then scale by -lr (read before the increment)
        torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(u, -float(np.float32(self.lr_at(count))))
        torch._foreach_add_(p, u)
        self.state["count"] = count + 1


def make_optimizer(lr=2e-4, weight_decay=1e-5, clip=1.0, warmup_steps=0,
                   total_steps=None):
    """AdamW + global-norm clip, optionally under a linear-warmup +
    cosine-decay schedule (warmup_steps > 0 requires total_steps); constant
    lr when warmup_steps == 0."""
    if warmup_steps > 0:
        if total_steps is None:
            raise ValueError("warmup schedule needs total_steps")
        lr = warmup_cosine_decay(lr, warmup_steps, total_steps, lr * 0.01)
    return AdamW(lr, weight_decay=weight_decay, clip=clip)


def as_batch(batch, device):
    """A batch dict of (B, H, W, C) arrays or tensors as float32 tensors on
    `device` (only the keys the loss reads)."""
    return {k: torch.as_tensor(batch[k]).to(device, torch.float32)
            for k in BATCH_KEYS if k in batch}


def make_loss_fn(model, compute_dtype=None):
    """loss_fn(params, batch) -> (total, metrics): the sequence loss of
    `model` run with `params` (name -> tensor) on a batch of device
    tensors. With a compute_dtype, params and images are cast inside the
    function, so gradients reach `params` in their own dtype."""

    def loss_fn(params, batch, counts=None):
        """counts: the (n, nq) to normalise by (`loss.valid_counts`)."""
        img0, img1 = batch["img0"], batch["img1"]
        if compute_dtype is not None:
            params = {k: v.to(compute_dtype) for k, v in params.items()}
            img0, img1 = img0.to(compute_dtype), img1.to(compute_dtype)
        disp, occ, conf, aux = functional_call(model, params, (img0, img1),
                                               {"return_aux": True})
        return sequence_loss(aux["disp_seq"], disp.float(), occ.float(), conf.float(),
                             batch["gt_disp"], batch["valid"], batch.get("gt_nonocc"),
                             counts=counts)
    return loss_fn


def value_and_grad(loss_fn, params, batch, mesh=None, rows=None):
    """(metrics, grads): the loss's metrics (detached) and its gradient with
    respect to every entry of `params`. With a `mesh` of more than one rank,
    `batch` is this rank's shard (`shard_batch`) and both are the whole
    batch's (module docstring); `rows`, every band's rows at full
    resolution (`band_rows`), runs the forward as this rank's band."""
    group = None if mesh is None else mesh.world_group
    counts = None
    if group is not None:
        counts = all_reduce(mesh, valid_counts(batch["valid"]), group)
    banded = band.sharded(mesh, rows) if rows is not None else contextlib.nullcontext()
    with banded:
        total, metrics = loss_fn(params, batch, counts)
    grads = torch.autograd.grad(total, list(params.values()))
    metrics = {k: v.detach() for k, v in metrics.items()}
    if group is not None:
        flat = all_reduce(mesh, torch.cat([g.reshape(-1).float() for g in grads]), group)
        grads = [f.view_as(g).to(g.dtype)
                 for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
        summed = all_reduce(mesh, torch.stack([v.float() for v in metrics.values()]),
                            group)
        metrics = dict(zip(metrics, summed.unbind()))
    return metrics, dict(zip(params, grads))


def batch_rows(batch, mesh):
    """Every band's rows of the batch's (B, H, W, C) images at full
    resolution (`band_rows`; raises unless H splits into whole 32-row blocks
    per band), or None without band sharding."""
    if mesh is None or mesh.n_band == 1:
        return None
    return band_rows(batch["img0"].shape[1], mesh.n_band)


def shard_batch(batch, mesh):
    """This rank's shard of every (B, H, ...) entry of a batch dict: its data
    slice of B and, with n_band > 1, its band's rows of H."""
    if mesh is None or mesh.size == 1:
        return batch
    if mesh.n_band == 1:
        return {k: data_slice(mesh, v) for k, v in batch.items()}
    sharding = image_sharding(mesh)
    # `shard` raises on a height that does not split into 32-row blocks
    return {k: sharding.shard(v) for k, v in batch.items()}


def make_train_step(cfg, model, optimizer, compute_dtype=None, mesh=None):
    """train_step(batch) -> metrics: one optimizer step of `model`'s own
    parameters (the fp32 masters, updated in place) on a batch dict of NHWC
    float32 arrays or tensors {img0, img1, gt_disp, valid[, gt_nonocc]}.
    `optimizer` (from `make_optimizer`) is initialised on the parameters
    unless it already holds a state. `cfg` is the model's configuration.
    With a `mesh` every rank passes the whole batch and takes its shard
    (`shard_batch`); the parameters are made equal on every rank first."""
    if model.cfg != cfg:
        raise ValueError("make_train_step: cfg is not the model's configuration")
    if mesh is not None:
        replicated(mesh)(model)
    params = dict(model.named_parameters())
    if optimizer.state is None:
        optimizer.init(params)
    loss_fn = make_loss_fn(model, compute_dtype)
    device = next(iter(params.values())).device

    def train_step(batch):
        rows = batch_rows(batch, mesh)
        metrics, grads = value_and_grad(loss_fn, params,
                                        as_batch(shard_batch(batch, mesh), device), mesh,
                                        rows)
        optimizer.update(params, grads)
        return metrics
    return train_step
