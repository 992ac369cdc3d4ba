"""The port's training step (s2m2_torch/train/step.py) against the JAX
package's (s2m2_tpu/train/step.py) on the CPU: the learning-rate schedule
and the optimizer against optax, one fp32 step of a small model against
jax.value_and_grad + optax, and the bf16 policy (fp32 masters)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from s2m2_torch.config import ModelConfig
from s2m2_torch.models.s2m2 import S2M2
from s2m2_torch.tools.convert import from_jax, to_jax
from s2m2_torch.train import step as tstep
from s2m2_torch.train.data import synthetic_stereo_batches

torch.set_num_threads(2)


@pytest.mark.parametrize("lr,warmup,total", [(2e-4, 2, 8), (1e-3, 10, 100),
                                             (3e-4, 0, None)])
def test_lr_schedule_matches_optax(lr, warmup, total):
    """The port's learning rate at every step (and beyond the end) equals
    optax's schedule to 1e-7, and to two float32 ulps of the peak rate
    (optax evaluates it in float32; XLA's cos and numpy's differ by an ulp
    at some steps)."""
    opt = tstep.make_optimizer(lr=lr, warmup_steps=warmup, total_steps=total)
    if warmup:
        ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, total, lr * 0.01)
    else:
        ref = lambda count: lr  # noqa: E731
    for count in range(0, (total or 20) + 5):
        want = float(ref(count))
        assert abs(opt.lr_at(count) - want) <= min(1e-7, 2.4e-7 * lr), count
    if warmup:
        assert opt.lr_at(0) == 0.0


def test_warmup_schedule_requires_total_steps():
    with pytest.raises(ValueError):
        tstep.make_optimizer(warmup_steps=10)
    tstep.make_optimizer(warmup_steps=10, total_steps=100)


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["below_clip", "clipped"])
def test_optimizer_matches_optax_on_fixed_gradients(scale):
    """Three updates with fixed gradients under a warmup schedule: the
    port's AdamW (clip, moments, bias correction, decay of every leaf)
    against optax's chain to 1e-6, with the clip off and on."""
    rng = np.random.default_rng(0)
    shapes = {"a.weight": (4, 3), "b.bias": (5,), "c.weight": (2, 2, 3, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    kw = dict(lr=1e-2, weight_decay=0.1, clip=1.0, warmup_steps=1, total_steps=5)
    ref = optax.chain(optax.clip_by_global_norm(kw["clip"]), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, kw["lr"], 1, 5, kw["lr"] * 0.01),
        weight_decay=kw["weight_decay"]))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = ref.init(jp)
    opt = tstep.make_optimizer(**kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt.init(tp)
    for i, g in enumerate(grads):
        upd, state = ref.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        before = {k: v.clone() for k, v in tg.items()}
        opt.update(tp, tg)
        for k in shapes:
            assert torch.equal(tg[k], before[k])  # grads left unchanged
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
        if i == 0:  # lr 0 at step 0 under warmup: nothing moves
            for k in shapes:
                np.testing.assert_array_equal(tp[k].numpy(), params[k])
    assert opt.state["count"] == 3


KW = dict(feature_channels=16, num_transformer=1, refine_iter=1)


@functools.lru_cache(maxsize=None)
def _jax():
    """(JAX config, seeded params, jitted value_and_grad of the JAX step's
    loss with the batch as arguments): compiled once per process."""
    from s2m2_tpu.config import ModelConfig as JaxConfig
    from s2m2_tpu.models.init import init_params
    from s2m2_tpu.models.s2m2 import forward
    from s2m2_tpu.train.loss import sequence_loss

    jcfg = JaxConfig(**KW)

    def loss_fn(p, img0, img1, gt, valid):
        d, o, c, aux = forward(p, img0, img1, jcfg, return_aux=True)
        return sequence_loss(aux["disp_seq"], d, o, c, gt, valid)[0]
    return jcfg, init_params(jcfg, seed=0), jax.jit(jax.value_and_grad(loss_fn))


def _batch(seed):
    return next(iter(synthetic_stereo_batches(batch=1, height=64, width=96,
                                              max_disp=12, n_batches=1, seed=seed)))


def _both_grads(seed):
    """(loss, grads) of the JAX package and of the port on one batch, from
    the same seeded weights; grads as JAX-layout arrays by dotted name."""
    from s2m2_tpu.tools.convert_checkpoint import flatten as jflatten
    _, jparams, vg = _jax()
    batch = _batch(seed)
    want_loss, want = vg(jparams, batch["img0"], batch["img1"], batch["gt_disp"],
                         batch["valid"])
    model = S2M2(ModelConfig(**KW))
    model.load_state_dict(from_jax({k: np.asarray(v) for k, v in jflatten(jparams).items()}))
    params = dict(model.named_parameters())
    metrics, grads = tstep.value_and_grad(tstep.make_loss_fn(model), params,
                                          tstep.as_batch(batch, "cpu"))
    return (float(want_loss), {k: np.asarray(v) for k, v in jflatten(want).items()},
            float(metrics["loss"]), grads, model)


def test_fp32_step_matches_jax():
    """One fp32 step of CH16/NTR1/refine_iter=1 at 64x96 from the JAX
    package's seeded init (batch seed 0, the seed of tests/test_train.py):
    the loss within 1e-5 relative, every gradient leaf within 1e-4 x that
    leaf's max |g| (atol 1e-7), and the parameters after one AdamW step
    (lr 1e-3, clip on) within 1e-6 of optax's on the JAX gradients."""
    want_loss, want, loss, grads, model = _both_grads(0)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    got = to_jax(grads)
    assert set(got) == set(want)
    for k, g in want.items():
        tol = 1e-4 * float(np.abs(g).max()) + 1e-7
        np.testing.assert_allclose(got[k], g, rtol=0, atol=tol, err_msg=k)

    # the parameters after one step (lr 1e-3, clip on). The port's AdamW on
    # the JAX gradients matches optax within 1e-6. The whole port step (its
    # own gradients) matches within 1e-6 plus what the gradients' own
    # difference explains: Adam's first update is g / (|g| + eps), +-lr
    # wherever |g| >> eps, so it moves an element by up to 2 lr |dg| / |g|
    # (6.6e-6 for 9 of conv1_down's 25,600 weights, whose |g| is near the
    # gradients' float32 difference)
    from s2m2_tpu.tools.convert_checkpoint import flatten as jflatten, nest
    jparams = _jax()[1]
    lr = 1e-3
    ref = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr, weight_decay=1e-5))
    upd, _ = ref.update(nest({k: jnp.asarray(v) for k, v in want.items()}),
                        ref.init(jparams), jparams)
    new_jparams = {k: np.asarray(v) for k, v in
                   jflatten(optax.apply_updates(jparams, upd)).items()}
    for port_grads, explained in ((from_jax(want), False), (grads, True)):
        model.load_state_dict(from_jax({k: np.asarray(v) for k, v in jflatten(jparams).items()}))
        params = dict(model.named_parameters())
        opt = tstep.make_optimizer(lr=lr)
        opt.init(params)
        opt.update(params, port_grads)
        after = to_jax(model.state_dict())
        for k, v in new_jparams.items():
            tol = 1e-6
            if explained:
                tol = tol + 2 * lr * np.abs(got[k] - want[k]) / np.maximum(np.abs(want[k]), 1e-30)
            assert (np.abs(after[k] - v) <= tol).all(), (k, explained)


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_gradients_match_jax_across_batches(seed):
    """The same comparison on five more batches: the loss within 1e-5
    relative and the whole gradient within 1e-4 in relative L2 norm. The
    per-leaf max bound of the seed-0 test is not held here: where the two
    forwards, which differ at float32 rounding (feature maps by ~1e-5),
    put a ReLU input within that distance of zero, one package passes the
    gradient and the other does not; at batch seed 3 that moves the mask
    head's conv_concat.0 gradient by 5e-3 of its max, in the JAX package
    against itself as much as against the port (the same JAX loss traced
    with the batch baked in as constants does it at seed 0)."""
    want_loss, want, loss, grads, _ = _both_grads(seed)
    assert loss == pytest.approx(want_loss, rel=1e-5)
    got = to_jax(grads)
    err = sum(float(((got[k] - g) ** 2).sum()) for k, g in want.items())
    norm = sum(float((g ** 2).sum()) for g in want.values())
    assert (err / norm) ** 0.5 < 1e-4


def test_bf16_policy_keeps_fp32_masters():
    """compute_dtype=bf16: the forward runs on bf16 copies, but the masters
    and their gradients stay float32, the loss is finite and the
    parameters move (as tests/test_train.py's bf16 case)."""
    cfg = ModelConfig(feature_channels=16, num_transformer=1, refine_iter=1)
    model = S2M2(cfg)
    from s2m2_torch.models.init import init_params
    model.load_state_dict(init_params(cfg, seed=0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = next(iter(synthetic_stereo_batches(batch=1, height=64, width=96,
                                               max_disp=12, n_batches=1)))
    params = dict(model.named_parameters())
    metrics, grads = tstep.value_and_grad(
        tstep.make_loss_fn(model, torch.bfloat16), params, tstep.as_batch(batch, "cpu"))
    assert np.isfinite(float(metrics["loss"]))
    assert metrics["loss"].dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert sum(bool(g.abs().sum() > 0) for g in grads.values()) > 0.9 * len(grads)
    opt = tstep.make_optimizer(lr=1e-3)
    step = tstep.make_train_step(cfg, model, opt, compute_dtype=torch.bfloat16)
    assert np.isfinite(float(step(batch)["loss"]))
    after = model.state_dict()
    assert all(v.dtype == torch.float32 for v in after.values())
    assert any(not torch.equal(after[k], before[k]) for k in before)
