"""The port's band-sharded forward (`StereoEngine(mesh=...)`, s2m2_torch/
parallel/) on gloo ranks of the CPU against its unsharded forward, within
the JAX test's 5e-5 (tests/test_parallel.py:38-39): 1x4 and 2x2 meshes with
the fused block off and on, an output_upsample config (and its
negative-disparity twin, whose confidence is held by the JAX package's
rule for discrete sensitivity), and a 160-row pair on 2 bands (96 + 64
rows) and on 3 (64 + 64 + 32). Each rank counts the
collectives of its forward, which must equal the counts worked out from the
config (`band.expected_counts`); the forward with no mesh issues none and
its outputs are those of a 1x1 mesh to the bit. Then the engine's own
checks: `run` gives every rank the unsharded maps, and a batch that does
not split or too few 32-row blocks raise."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from s2m2_torch.config import ModelConfig
from s2m2_torch.parallel.mesh import Mesh, make_mesh
from s2m2_torch.runtime.engine import StereoEngine

from tests.torch_parallel_ranks import SMALL, run, small_pair

torch.set_num_threads(2)
CASES = {  # world: [(id, case)]
    4: [("1x4", dict(mesh=(1, 4))),
        ("1x4-fused", dict(mesh=(1, 4), fused=True)),
        ("2x2", dict(mesh=(2, 2))),
        ("2x2-fused", dict(mesh=(2, 2), fused=True)),
        ("2x2-output_upsample", dict(mesh=(2, 2), cfg=dict(output_upsample=True))),
        ("2x2-output_upsample-negative", dict(mesh=(2, 2), control=True, cfg=dict(
            output_upsample=True, use_positivity=False)))],
    2: [("160rows-1x2", dict(mesh=(1, 2), shape=(1, 160, 96)))],
    3: [("160rows-1x3", dict(mesh=(1, 3), shape=(1, 160, 96)))],
}
IDS = [(w, i) for w, cases in CASES.items() for i in range(len(cases))]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{world: each rank's list of case results}, one run per world."""
    return {w: run("forward", w, tmp_path_factory.mktemp(f"fwd{w}"),
                   cases=[c for _, c in cases]) for w, cases in CASES.items()}


@pytest.mark.parametrize("world,index", IDS, ids=[CASES[w][i][0] for w, i in IDS])
def test_band_sharded_forward_matches_unsharded(sharded, world, index):
    """Every output within 5e-5 of the unsharded forward, with one
    exception: the confidence of the config with negative disparities
    allowed (disp and occ stay at 5e-5). Its confidence moves in discrete
    quanta: one quarter-grid pixel that flips moves a patch of about 28 x 28
    output pixels by up to 4e-3, and a 1e-6 relative change of image a
    alone flips some. So that conf is held to the JAX package's rule for a
    route with discrete sensitivity (tests/test_parallel.py:121-137): max
    |d| < max(2 C, 0.02) and the 99th percentile below half of that, C
    being the largest change of the unsharded forward over four 1e-6
    relative changes of the input (a and b, each times 1 + 1e-6 and 1 -
    1e-6). The band seams stay held at 5e-5 by the positivity
    output_upsample case beside it, the same code apart from the matcher's
    mask and the refiner's clamps, both row-local."""
    case = CASES[world][index][1]
    for rank, results in enumerate(sharded[world]):
        res = results[index]
        for i, (err, name) in enumerate(zip(res["err"], ("disp", "occ", "conf"))):
            if name == "conf" and res["control"] is not None:
                bound = max(2 * res["control"][i], 0.02)
                assert err < bound, (rank, name, err, res["control"])
                assert res["p99"][i] < bound / 2, (rank, name, res["p99"][i], bound)
            else:
                assert err <= 5e-5, (rank, name, err)
        if case["mesh"][1] > 1:
            assert res["counts"] == res["expected"], (rank, res["counts"], res["expected"])


class _CountingDist:
    """Stands in for the collectives torch.distributed would run."""

    NAMES = ("batch_isend_irecv", "all_reduce", "all_gather", "broadcast", "send", "recv",
             "isend", "irecv", "barrier", "all_gather_object")

    def __init__(self, monkeypatch):
        self.calls = []
        for name in self.NAMES:
            monkeypatch.setattr(dist, name, self._record(name))

    def _record(self, name):
        def call(*args, **kwargs):
            self.calls.append(name)
            raise AssertionError(f"collective {name} on the one-device path")
        return call


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_no_mesh_no_collective(monkeypatch, precision):
    """With no mesh (and with a 1x1 mesh, which needs no process group) the
    forward issues no collective, and the two give the same outputs to the
    bit."""
    counting = _CountingDist(monkeypatch)
    cfg = ModelConfig(**SMALL)
    a, b = small_pair(1, 64, 96)
    plain = StereoEngine(cfg, precision=precision, device="cpu").forward_padded(a, b)
    one = StereoEngine(cfg, precision=precision, device="cpu",
                       mesh=make_mesh(device="cpu")).forward_padded(a, b)
    assert counting.calls == []
    for p, o in zip(plain, one):
        assert torch.equal(p, o)


@pytest.fixture(scope="module")
def engine_checks(tmp_path_factory):
    return run("engine_checks", 2, tmp_path_factory.mktemp("engine"))


def test_mesh_run_returns_unsharded_maps_on_every_rank(engine_checks):
    """run() on a 100x90 HWC pair (padded to 128x96, bands 64 + 64)."""
    for rank, res in enumerate(engine_checks):
        assert res["shape"] == (100, 90)
        assert max(res["err"]) <= 5e-5, (rank, res["err"])
        assert res["ms"] == engine_checks[0]["ms"]   # the slowest rank's, on all


def test_mesh_refuses_uneven_batch_and_too_few_blocks(engine_checks):
    for res in engine_checks:
        assert "does not split over 2 data ranks" in res["odd_batch"]
        assert "fewer than the 2 bands" in res["few_blocks"]


def test_mesh_device_must_match_engine():
    mesh = Mesh(1, 1, 0, 0, torch.device("meta"), None)
    with pytest.raises(ValueError, match="the mesh is on"):
        StereoEngine(ModelConfig(**SMALL), device="cpu", mesh=mesh)
