"""Supervised stereo losses, from `s2m2_tpu/train/loss.py` (the reference
ships no training code).

- masked L1 on disparity over valid ground-truth pixels;
- BCE on the occlusion head against ground-truth non-occlusion (when given);
- BCE on the confidence head against the induced target
  1[|disp_pred - disp_gt| < 4 px], the reference's stated meaning of the
  confidence output;
- RAFT-style sequence supervision of the refiner's quarter-resolution
  iterates with weights gamma^(N-i).

Inputs are (B, H, W, 1) tensors, as the JAX package's forward and the port's
`S2M2.forward` return them; every loss is computed in float32.
"""
from __future__ import annotations

import torch


def _bce(pred, target, eps=1e-6):
    p = pred.float().clamp(eps, 1 - eps)
    t = target.float()
    return -(t * torch.log(p) + (1 - t) * torch.log(1 - p))


def stereo_loss(disp, occ, conf, gt_disp, valid, gt_nonocc=None,
                conf_threshold=4.0, w_disp=1.0, w_occ=0.5, w_conf=0.5, n=None):
    """All inputs (B, H, W, 1); valid is a {0,1} mask of supervised pixels.

    Returns (total_loss, metrics dict). Occlusion supervision is skipped when
    gt_nonocc is None (sparse datasets often lack it). n: the count of
    supervised pixels to normalise by (default: this batch's, at least 1);
    a data-parallel step gives the whole batch's, summed over its ranks."""
    valid = valid.float()
    if n is None:
        n = valid.sum().clamp(min=1.0)

    err = (disp.float() - gt_disp.float()).abs()
    l_disp = (err * valid).sum() / n

    conf_target = (err < conf_threshold).float()
    l_conf = (_bce(conf, conf_target) * valid).sum() / n

    total = w_disp * l_disp + w_conf * l_conf
    metrics = {"loss_disp": l_disp, "loss_conf": l_conf, "epe": l_disp}
    if gt_nonocc is not None:
        l_occ = (_bce(occ, gt_nonocc) * valid).sum() / n
        total = total + w_occ * l_occ
        metrics["loss_occ"] = l_occ
    metrics["loss"] = total
    return total, metrics


def _downsample4(x):
    """(B, H, W, 1) -> (B, H/4, W/4, 1) average pool (GT to the 1/4 grid);
    H and W must be multiples of 4."""
    b, h, w, c = x.shape
    if h % 4 or w % 4:
        raise ValueError(f"_downsample4 needs H and W divisible by 4, got {(h, w)}")
    return x.reshape(b, h // 4, 4, w // 4, 4, c).mean(dim=(2, 4))


def valid_counts(valid):
    """(n, nq) float32: the supervised pixels at full resolution and on the
    quarter grid, the denominators of `sequence_loss` (before their clamp at
    1). A data-parallel step sums them over its ranks first: each rank's
    loss is then its share of the whole batch's, and the shares add up."""
    v = valid.float()
    return torch.stack([v.sum(), (_downsample4(v) > 0.999).float().sum()])


def sequence_loss(disp_seq, disp_final, occ, conf, gt_disp, valid,
                  gt_nonocc=None, gamma=0.8, counts=None, **kw):
    """RAFT-style exponentially weighted sequence supervision.

    disp_seq: the per-refine-iteration quarter-resolution disparities in
    full-resolution px units (`S2M2.forward(..., return_aux=True)
    ['disp_seq']`, the OT/global init first). Each gets weight
    gamma^(N-i) against the 4x-downsampled ground truth; the final
    full-resolution output carries the full `stereo_loss` (weight 1).
    counts: (n, nq) to normalise by in place of this batch's
    (`valid_counts`)."""
    n = None if counts is None else counts[0].clamp(min=1.0)
    total, metrics = stereo_loss(disp_final, occ, conf, gt_disp, valid,
                                 gt_nonocc, n=n, **kw)
    gt_q = _downsample4(gt_disp.float())
    # a quarter-res pixel is supervised only if all 16 source pixels were valid
    valid_q = (_downsample4(valid.float()) > 0.999).float()
    nq = valid_q.sum().clamp(min=1.0) if counts is None else counts[1].clamp(min=1.0)
    n_seq = len(disp_seq)
    l_seq = 0.0
    for i, d in enumerate(disp_seq):
        w_i = gamma ** (n_seq - i)
        err = (d.float() - gt_q).abs()
        l_seq = l_seq + w_i * (err * valid_q).sum() / nq
    total = total + l_seq
    metrics["loss_seq"] = l_seq
    metrics["loss"] = total
    return total, metrics
