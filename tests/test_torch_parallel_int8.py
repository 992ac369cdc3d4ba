"""The port's int8 engine band-sharded on a 2x2 gloo mesh of the CPU: each
rank calibrates on the full padded pair, unsharded, and every rank's scales
must be identical (and the unsharded engine's); then the sharded int8
forward against the unsharded one under the JAX test's rule
(tests/test_parallel.py:130-137): max |diff| below the larger of 0.02 and
twice the unsharded forward's change under a 1e-6 relative input
perturbation, and the 99th percentile below half of that. E's pack and GEMM
records (the plain versions log them on the CPU as kernel E's launches on
the card) must equal the unsharded forward's."""
import numpy as np
import pytest

from tests.torch_parallel_ranks import run


@pytest.fixture(scope="module", params=["int8", "int8r"])
def sharded_int8(request, tmp_path_factory):
    return run("int8", 4, tmp_path_factory.mktemp(request.param), precision=request.param)


def test_int8_band_sharded_matches_unsharded(sharded_int8):
    for rank, res in enumerate(sharded_int8):
        bound = max(2.0 * res["pert"], 0.02)
        for g, r, name in zip(res["got"], res["ref"], ("disp", "occ", "conf")):
            d = np.abs(g - r)
            assert float(d.max()) < bound, (rank, name, d.max(), bound)
            assert float(np.percentile(d, 99)) < bound / 2, (rank, name)


def test_int8_scales_identical_on_every_rank(sharded_int8):
    first = sharded_int8[0]["scales"]
    assert len(first) > 50
    for res in sharded_int8:
        assert np.array_equal(res["scales"], first)
        assert np.array_equal(res["ref_scales"], first)


def test_int8_band_sharded_launches_equal_unsharded(sharded_int8):
    for res in sharded_int8:
        assert res["e"] == res["ref_e"]
        assert res["e"]["pack"] > 0 and res["e"]["gemm"] > 0
