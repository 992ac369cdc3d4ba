"""The port's training losses (s2m2_torch/train/loss.py) against the JAX
package's (s2m2_tpu/train/loss.py) on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2m2_torch.train import loss as tloss
from s2m2_tpu.train import loss as jloss


def _inputs(seed, b=2, h=16, w=24, n_seq=3):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 20, (b, h, w, 1)).astype(np.float32)
    valid = (rng.uniform(size=(b, h, w, 1)) > 0.2).astype(np.float32)
    disp = (gt + rng.normal(0, 5, gt.shape)).astype(np.float32)
    occ = rng.uniform(0, 1, gt.shape).astype(np.float32)
    conf = rng.uniform(0, 1, gt.shape).astype(np.float32)
    conf[0, 0, :4, 0] = [0.0, 1.0, 1e-7, 1 - 1e-7]  # inside and beyond the clip
    nonocc = (rng.uniform(size=gt.shape) > 0.3).astype(np.float32)
    seq = [(gt[:, ::4, ::4] + rng.normal(0, 3, (b, h // 4, w // 4, 1))).astype(np.float32)
           for _ in range(n_seq)]
    return disp, occ, conf, gt, valid, nonocc, seq


def _check(got, want, rel=1e-6):
    total, metrics = got
    wtotal, wmetrics = want
    assert float(total) == pytest.approx(float(wtotal), rel=rel)
    assert set(metrics) == set(wmetrics)
    for k in wmetrics:
        assert float(metrics[k]) == pytest.approx(float(wmetrics[k]), rel=rel), k


@pytest.mark.parametrize("with_nonocc", [False, True], ids=["no_gt_nonocc", "gt_nonocc"])
def test_stereo_loss_matches_jax(with_nonocc):
    disp, occ, conf, gt, valid, nonocc, _ = _inputs(0)
    t = [torch.from_numpy(a) for a in (disp, occ, conf, gt, valid)]
    j = [jnp.asarray(a) for a in (disp, occ, conf, gt, valid)]
    tn = torch.from_numpy(nonocc) if with_nonocc else None
    jn = jnp.asarray(nonocc) if with_nonocc else None
    _check(tloss.stereo_loss(*t, tn), jloss.stereo_loss(*j, jn))


@pytest.mark.parametrize("with_nonocc", [False, True], ids=["no_gt_nonocc", "gt_nonocc"])
def test_sequence_loss_matches_jax(with_nonocc):
    """gamma 0.8 weights gamma^(N-i), quarter-res validity > 0.999."""
    disp, occ, conf, gt, valid, nonocc, seq = _inputs(1)
    valid[0, 5, 5, 0] = 0.0  # one invalid pixel makes its quarter-res cell invalid
    t = [torch.from_numpy(a) for a in (disp, occ, conf, gt, valid)]
    j = [jnp.asarray(a) for a in (disp, occ, conf, gt, valid)]
    tn = torch.from_numpy(nonocc) if with_nonocc else None
    jn = jnp.asarray(nonocc) if with_nonocc else None
    _check(tloss.sequence_loss([torch.from_numpy(s) for s in seq], *t, tn),
           jloss.sequence_loss([jnp.asarray(s) for s in seq], *j, jn))


def test_sequence_loss_weights_and_targets():
    """tests/test_train.py's gamma-weighting case on the port: two
    intermediates +2 and +1 px off the pooled GT at gamma 0.5 give
    0.25 * 2 + 0.5 * 1 = 1.0."""
    rng = np.random.default_rng(0)
    b, h, w = 1, 16, 16
    gt = torch.from_numpy(rng.uniform(2, 10, (b, h, w, 1)).astype(np.float32))
    valid = torch.ones((b, h, w, 1))
    final = gt + 1.0
    occ = torch.full((b, h, w, 1), 0.9)
    conf = torch.full((b, h, w, 1), 0.9)
    gt_q = gt.numpy().reshape(b, h // 4, 4, w // 4, 4, 1).mean((2, 4))
    seq = [torch.from_numpy(gt_q + 2.0), torch.from_numpy(gt_q + 1.0)]
    total, m = tloss.sequence_loss(seq, final, occ, conf, gt, valid, gamma=0.5)
    base, _ = tloss.stereo_loss(final, occ, conf, gt, valid)
    assert float(m["loss_seq"]) == pytest.approx(1.0, rel=1e-5)
    assert float(total) == pytest.approx(float(base) + 1.0, rel=1e-5)


def test_loss_gradients_match_jax():
    """The gradient of the sequence loss with respect to every prediction."""
    import jax
    disp, occ, conf, gt, valid, nonocc, seq = _inputs(2)
    preds = [disp, occ, conf] + seq
    tp = [torch.from_numpy(a).requires_grad_() for a in preds]
    total, _ = tloss.sequence_loss(tp[3:], *tp[:3], torch.from_numpy(gt),
                                   torch.from_numpy(valid), torch.from_numpy(nonocc))
    got = torch.autograd.grad(total, tp)

    def f(*p):
        return jloss.sequence_loss(list(p[3:]), *p[:3], jnp.asarray(gt), jnp.asarray(valid),
                                   jnp.asarray(nonocc))[0]
    want = jax.grad(f, argnums=tuple(range(len(preds))))(*(jnp.asarray(a) for a in preds))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-9)


def test_downsample4_needs_multiples_of_4():
    with pytest.raises(ValueError):
        tloss._downsample4(torch.zeros(1, 6, 8, 1))
