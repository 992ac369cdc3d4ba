"""The backward of band sharding's primitives (s2m2_torch/parallel/band.py,
reached through the cross-row primitives of s2m2_torch/models/) on 2 and 3
gloo ranks of the CPU: each primitive's gradient on a band against the
unsharded autograd's, the backward run after the band context has closed
(as a training step runs it). 96 rows on 2 ranks are bands of 64 + 32, 160
rows on 3 are 64 + 64 + 32, so the gather's reduce-scatter meets bands of
unequal size. The cases: convolutions (the halo's gradient sent back and
added into the neighbour's edge rows), a ConvBlock2D (both branches'
gradients on its one halo), bilinear x2 and the 3x3 unfold (the "edge"
fill's rows summed into the edge row), GroupNorm (both all-reduces), and a
1/32 global-attention block (the gather, whose parameters' gradients are
partial on each band and summed)."""
import pytest
import torch

from tests.torch_parallel_ranks import run

CASES = ("conv3x3", "conv5x5_s2", "conv3x3_s2", "conv3x1", "convT3x3", "conv_block2d",
         "upsample2x_bilinear", "unfold9", "group_norm_mean0", "group_norm_mean100",
         "global_blocks")
HALO_CASES = {"conv_block2d": 4}   # forward + backward halos; every other case 2


@pytest.fixture(scope="module")
def grads(tmp_path_factory):
    """{world: each rank's {case: (input err, parameter err, |mean|, counts)}}."""
    return {w: run("primitive_grads", w, tmp_path_factory.mktemp(f"grads{w}"), h=h)
            for w, h in ((2, 96), (3, 160))}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", CASES)
def test_band_primitive_backward_matches_unsharded(grads, world, case):
    """The input's gradient within 1e-6 of max(1, its largest magnitude);
    the parameters' gradients, summed over the bands, within 1e-5 relative
    L2 (each is a sum over every pixel, here up to 6,400 terms a weight,
    which the bands add in another order: 1.5e-6 measured on the ConvT's).
    GroupNorm: both within 1e-5 x (1 + |mean|), the rule of the forward's
    test (tests/test_torch_parallel_ops.py). The forward and the backward
    each count their collectives."""
    for rank, res in enumerate(grads[world]):
        err, perr, mean, counts = res[case]
        gn = case.startswith("group_norm")
        assert err <= (1e-5 * (1 + mean) if gn else 1e-6), (world, rank, case, err)
        assert perr <= 1e-5 * (1 + mean), (world, rank, case, perr)
        if gn:
            want = {"halo": 0, "all_reduce": 4, "all_gather": 0}
        elif case == "global_blocks":  # the gather's backward is an all-reduce
            want = {"halo": 0, "all_reduce": 1, "all_gather": 1}
        else:
            want = {"halo": HALO_CASES.get(case, 2), "all_reduce": 0, "all_gather": 0}
        assert counts == want, (world, rank, case, counts)


@pytest.mark.parametrize("variant,want", [("S", (253, 10, 6)), ("XL", (265, 12, 8))])
def test_expected_counts_of_a_training_step(variant, want):
    """A training step's forward and backward, per rank: each halo's and
    all-reduce's backward once more, but the halo of the 1x mask's RGB
    ConvT, whose input (the image) takes no gradient; each gather's
    backward one all-reduce."""
    from s2m2_torch.config import get_config
    from s2m2_torch.parallel import band
    fwd = band.expected_counts(get_config(variant))
    both = band.expected_counts(get_config(variant), backward=True)
    assert tuple(both.values()) == want
    assert both == {"halo": 2 * fwd["halo"] - 1,
                    "all_reduce": 2 * fwd["all_reduce"] + fwd["all_gather"],
                    "all_gather": fwd["all_gather"]}
