"""Band sharding's primitives (s2m2_torch/parallel/band.py and the
cross-row primitives of s2m2_torch/models/layers.py) on 2 and 3 gloo ranks
of the CPU: each sharded primitive's rows against the unsharded
primitive's, bands of unequal size included (96 rows on 2 ranks are 64 +
32); and the band bookkeeping in one process."""
import pytest
import torch

from s2m2_torch.config import ModelConfig, get_config
from s2m2_torch.models.layers import conv_halo_rows
from s2m2_torch.parallel import band
from s2m2_torch.parallel.mesh import Mesh, band_rows

from tests.torch_parallel_ranks import run

CASES = ("conv3x3", "conv5x5_s2", "conv3x3_s2", "conv3x1", "conv1x3", "convT3x3",
         "upsample2x_bilinear", "unfold9", "output_upsample_bilinear",
         "group_norm_mean0", "group_norm_mean100")


@pytest.fixture(scope="module")
def sharded_ops(tmp_path_factory):
    """{world: each rank's {case: (max |err|, |mean|)}}, one run per world."""
    return {w: run("primitives", w, tmp_path_factory.mktemp(f"ops{w}"))
            for w in (2, 3)}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", CASES)
def test_sharded_primitive_matches_unsharded(sharded_ops, world, case):
    """Within 1e-6 on every rank; GroupNorm within 1e-5 x (1 + |mean|), the
    rule of tests/test_torch_layers.py::test_group_norm (a sum split over
    ranks adds terms of size |mean| in another order)."""
    for rank, res in enumerate(sharded_ops[world]):
        err, mean = res[case]
        bound = 1e-5 * (1 + mean) if case.startswith("group_norm") else 1e-6
        assert err <= bound, (world, rank, case, err, bound)


def test_band_rows_whole_blocks():
    assert band_rows(128, 4) == [32, 32, 32, 32]
    assert band_rows(160, 2) == [96, 64]
    assert band_rows(160, 3) == [64, 64, 32]
    assert band_rows(1024, 1) == [1024]
    with pytest.raises(ValueError, match="fewer than"):
        band_rows(64, 3)
    with pytest.raises(ValueError, match="multiple of 32"):
        band_rows(100, 2)


def test_conv_halo_rows():
    """(top, bottom) rows read beyond a band, for the model's convs."""
    assert conv_halo_rows(3, 1, 1) == (1, 1)   # 3x3 and the ConvGRU's (3, 1)
    assert conv_halo_rows(5, 2, 2) == (2, 1)   # conv1_down
    assert conv_halo_rows(3, 2, 1) == (1, 0)   # conv2_down
    assert conv_halo_rows(1, 1, 0) == (0, 0)   # (1, k) and pointwise


def test_band_context_rules():
    mesh = Mesh(1, 2, 0, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="one band"):
        with band.sharded(Mesh(1, 1, 0, 0, torch.device("cpu"), None), [64]):
            pass
    with pytest.raises(ValueError, match="2 bands"):
        with band.sharded(mesh, [64, 32, 32]):
            pass
    assert not band.active()
    with band.sharded(mesh, [96, 64]) as ctx:
        assert band.active()
        assert ctx.scaled_rows(24) == [24, 16]    # 1/4 of 96 + 64
        assert ctx.scaled_rows(3) == [3, 2]       # 1/32
        with pytest.raises(ValueError, match="fill"):
            band.halo(torch.zeros(1, 1, 4, 4), 1, 1, fill="mirror")
        with pytest.raises(ValueError, match="halo rows"):
            band.halo(torch.zeros(1, 1, 1, 4), 2, 1)
    assert not band.active()
    assert band.last_counts()["counts"] == {"halo": 0, "all_reduce": 0, "all_gather": 0}


@pytest.mark.parametrize("variant,want", [("S", (127, 2, 6)), ("XL", (133, 2, 8))])
def test_expected_counts(variant, want):
    """One band-sharded forward's collectives per rank at the published
    configs (refine_iter 3): S NTR1, XL NTR3."""
    got = band.expected_counts(get_config(variant))
    assert (got["halo"], got["all_reduce"], got["all_gather"]) == want
    up = band.expected_counts(ModelConfig(feature_channels=32, num_transformer=1,
                                          refine_iter=1, output_upsample=True))
    assert up["halo"] == 45 + 3 + 26 + 6
