"""The slice against JAX: the JAX package's band-sharded forward (a 2x4
mesh of the 8 virtual CPU devices, as tests/test_parallel.py:24-36) and the
port's band-sharded forward (a 2x2 gloo mesh of the CPU) on the same
seed-0 weights and pair, within `_assert_parity`'s bounds
(tests/test_torch_model.py:47-49: disp 2e-2, occ/conf 2e-3, EPE 1e-3)."""
import jax
import jax.numpy as jnp
import numpy as np

from tests.torch_parallel_ranks import SMALL, run, small_pair


def test_band_sharded_forward_matches_jax_band_sharded(tmp_path):
    from s2m2_tpu.config import ModelConfig
    from s2m2_tpu.models.init import init_params
    from s2m2_tpu.models.s2m2 import forward
    from s2m2_tpu.parallel.mesh import image_sharding, make_mesh, replicated

    cfg = ModelConfig(**SMALL)
    img0, img1 = (jnp.asarray(x) for x in small_pair())
    mesh = make_mesh(n_data=2, n_band=4)
    img_s, rep = image_sharding(mesh), replicated(mesh)
    f = jax.jit(lambda p, a, b: forward(p, a, b, cfg), in_shardings=(rep, img_s, img_s))
    want = [np.asarray(o) for o in f(jax.device_put(init_params(cfg, seed=0), rep),
                                     jax.device_put(img0, img_s),
                                     jax.device_put(img1, img_s))]

    results = run("forward", 4, tmp_path, cases=[dict(mesh=(2, 2), keep=True)])
    for rank, res in enumerate(results):
        disp, occ, conf = res[0]["outs"]
        np.testing.assert_allclose(disp, want[0], atol=2e-2, err_msg=f"rank {rank}")
        np.testing.assert_allclose(occ, want[1], atol=2e-3, err_msg=f"rank {rank}")
        np.testing.assert_allclose(conf, want[2], atol=2e-3, err_msg=f"rank {rank}")
        assert np.abs(disp - want[0]).mean() < 1e-3
