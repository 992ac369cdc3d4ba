"""`s2m2_torch.ops.sinkhorn.plan`: the route kernel C takes for each shape,
decided on the CPU from the shape alone. The resident route keeps the whole
float32 row in the shared memory of a thread-block cluster; the streamed
route keeps it in a global workspace. The kernel itself runs only on a card
(tests/test_torch_kernels.py)."""
import itertools

import pytest
import torch

from s2m2_torch.ops import sinkhorn

WIDTHS = (8, 40, 152, 304, 305, 608, 640, 1216)
CHANNELS = (24, 128, 384, 768)
DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("w", WIDTHS)
def test_resident_plans_fit_one_block_and_a_cluster_of_eight(w):
    """Every resident plan of every (C, dtype, positivity): a cluster of 1,
    2, 4 or 8 CTAs whose slabs cover the row, at most 232,448 shared bytes
    a CTA (the layout `_resident_smem` mirrors), and correlation passes
    that cover every column: bf16 at most 32 32 x 32 tiles (2 a warp of
    a 512-thread CTA, mma.sync), float32 at most 80 rows and 160 columns
    (FFMA, 5 x 5 a thread)."""
    for c, dtype, pos in itertools.product(CHANNELS, DTYPES, (True, False)):
        p = sinkhorn.plan(w, c, dtype, pos)
        if p.route != "resident":
            continue
        assert p.cluster in (1, 2, 4, 8)
        assert p.rows == -(-w // p.cluster) and p.rows * p.cluster >= w
        assert p.smem <= 232448
        assert p.smem == sinkhorn._resident_smem(w, p.cluster, p.cols, p.stages, p.chunk)
        # the slab alone: rows x a pitch of at least W floats
        assert p.smem > p.rows * w * 4
        assert p.cols % 16 == 0 and p.cols * p.passes >= w
        assert p.cols * (p.passes - 1) < w
        m_tiles = -(-p.rows // 16)
        assert m_tiles <= 10  # the column sweeps' 16-row groups
        if dtype == torch.float32:
            assert 16 * m_tiles <= 80 and p.cols <= 160
        else:
            assert -(-m_tiles // 2) * -(-p.cols // 32) <= 32
        assert 2 <= p.stages <= (6 if p.chunk == 64 else 4) and p.chunk in (32, 64)
        assert p.threads == 512


@pytest.mark.parametrize("c", CHANNELS)
def test_main_path_shapes_take_the_resident_route(c):
    """S's and XL's 1216x1024 matcher rows (W = 304; C = 128 and 384) and
    every C here, no workspace: bf16 a cluster of 2 CTAs of 152 rows, the
    correlation in two passes of 160 columns; float32 a cluster of 4 CTAs of
    76 rows (the FFMA correlation takes at most 80), two passes of 160. The
    choice does not depend on C or positivity."""
    for dtype, cluster, rows in ((torch.bfloat16, 2, 152), (torch.float32, 4, 76)):
        plans = {sinkhorn.plan(304, c, dtype, pos) for pos in (True, False)}
        assert len(plans) == 1
        (p,) = plans
        assert (p.route, p.cluster, p.rows) == ("resident", cluster, rows)
        assert (p.passes, p.cols) == (2, 160)


def test_route_by_width():
    """Rows up to W = 152 fit one CTA; W = 305 takes a cluster of 2 with
    slabs of 153 and 152 rows, W = 608 a cluster of 8 and two correlation
    passes; wider rows the streamed route."""
    route = {w: sinkhorn.plan(w, 128, torch.bfloat16) for w in WIDTHS}
    assert [route[w].cluster for w in (8, 40, 152, 305, 608)] == [1, 1, 1, 2, 8]
    assert route[305].rows == 153
    assert all(route[w].route == "resident" for w in (8, 40, 152, 304, 305, 608))
    assert route[608].passes == 2
    assert route[640].route == route[1216].route == "streamed"
    assert route[1216].smem == 2 * 1217 * 4


def test_plan_rejects_what_no_route_runs():
    with pytest.raises(TypeError):
        sinkhorn.plan(304, 128, torch.float16)
    with pytest.raises(ValueError):
        sinkhorn.plan(0, 128, torch.float32)
    with pytest.raises(ValueError):
        sinkhorn.plan(3072, 128, torch.float32)
