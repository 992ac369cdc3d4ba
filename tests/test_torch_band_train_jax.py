"""The port's band-sharded training step against the JAX package's, on the
JAX test's config (tests/test_train.py:77-100: CH16, NTR=2, refine_iter 1,
batch 2 at 64x96 from the JAX package's synthetic scenes, seed 2): the
port's 2x2 step on gloo ranks of the CPU against JAX's step sharded over
its 2x4 mesh of the 8 virtual CPU devices (GSPMD's collectives). Loss
within 1e-5 relative, the whole gradient within 1e-4 relative L2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2m2_torch.tools.convert import flatten, from_jax

from tests.torch_parallel_ranks import run

torch.set_num_threads(2)
CFG = dict(feature_channels=16, num_transformer=2, refine_iter=1)


@pytest.fixture(scope="module")
def jax_step():
    """(batch, loss, {port name: gradient}) of JAX's sharded step."""
    from s2m2_tpu.config import ModelConfig
    from s2m2_tpu.models.init import init_params
    from s2m2_tpu.models.s2m2 import forward
    from s2m2_tpu.parallel.mesh import image_sharding, make_mesh, replicated
    from s2m2_tpu.train.data import synthetic_stereo_batches
    from s2m2_tpu.train.loss import sequence_loss
    cfg = ModelConfig(**CFG)
    batch = next(iter(synthetic_stereo_batches(batch=2, height=64, width=96, max_disp=12,
                                               n_batches=1, seed=2)))
    mesh = make_mesh(n_data=2, n_band=4)
    img_s, rep = image_sharding(mesh), replicated(mesh)

    def loss_fn(params, b):
        disp, occ, conf, aux = forward(params, b["img0"], b["img1"], cfg, return_aux=True)
        return sequence_loss(aux["disp_seq"], disp, occ, conf, b["gt_disp"], b["valid"])[0]

    params = jax.device_put(init_params(cfg, seed=0), rep)
    sharded = {k: jax.device_put(jnp.asarray(v), img_s) for k, v in batch.items()}
    step = jax.jit(jax.value_and_grad(loss_fn),
                   in_shardings=(rep, {k: img_s for k in sharded}))
    loss, grads = step(params, sharded)
    grads = from_jax(flatten(jax.tree.map(np.asarray, grads)))
    return batch, float(loss), {k: np.asarray(v) for k, v in grads.items()}


def test_band_sharded_step_matches_jax(jax_step, tmp_path):
    batch, want_loss, want = jax_step
    path = tmp_path / "batch.npz"
    np.savez(path, **batch)
    res = run("train_band", 4, tmp_path, timeout=300, mesh=[2, 2], cfg=CFG,
              batch_path=str(path))
    norm = np.sqrt(sum(np.linalg.norm(g) ** 2 for g in want.values()))
    for rank, r in enumerate(res):
        got = r["band"]
        assert got["shard"] == (1, 32, 96, 3)
        loss = got["metrics"]["loss"]
        assert abs(loss - want_loss) <= 1e-5 * want_loss, (rank, loss, want_loss)
        assert set(got["grads"]) == set(want)
        err = np.sqrt(sum(np.linalg.norm(got["grads"][k] - g) ** 2 for k, g in want.items()))
        assert err <= 1e-4 * norm, (rank, err / norm)
        assert got["counts"] == r["expected"], (rank, got["counts"], r["expected"])
