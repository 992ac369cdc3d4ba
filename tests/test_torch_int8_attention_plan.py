"""Kernel F's plan (`ops.int8_attention.plan`), checked on the CPU: every
shape the int8_attn route gives F in one forward of each published variant
at 1216x1024, and every card-test shape, gets a plan whose route, padding,
tiles, stages, shared memory and workspace layout agree with the kernel's
geometry (csrc/int8_attention.cu `geometry`), and the generated header
compiles each chunk width the plan can pick."""
import pytest
import torch

import chip_smoke
from s2m2_torch.config import VARIANTS, get_config
from s2m2_torch.ops import int8_attention as ia
from tests.test_torch_kernels import F_CARD_CASES

DTYPES = (torch.bfloat16, torch.float32)


def _shapes():
    """(b, nq, nk, d) of every int8_attn call of S, M, L and XL at
    1216x1024, then the card tests'."""
    out = []
    for model in sorted(VARIANTS):
        for b, n, d in chip_smoke.int8_attn_shapes(get_config(model), 1024, 1216):
            out.append((b, n, n, d))
    out += [(b, nq, nk, d) for (b, nq, d), nk in F_CARD_CASES]
    return sorted(set(out))


def _cdiv(a, b):
    return -(-a // b)


def _check_plan(pl, b, nq, nk, d):
    assert pl.dp % 32 == 0 and d <= pl.dp < d + 32
    assert pl.nkp % 16 == 0 and nk <= pl.nkp < nk + 16
    assert pl.dtiles == _cdiv(pl.dp, ia.KTB)
    assert pl.dch in ia.DCHS and pl.chunks * pl.dch >= pl.dp > (pl.chunks - 1) * pl.dch
    assert (pl.qblocks - 1) * ia.BQ < nq <= pl.qblocks * ia.BQ
    assert (pl.ktiles - 1) * ia.BKEY < nk <= pl.ktiles * ia.BKEY
    assert pl.units == b * pl.qblocks * pl.chunks
    if pl.ktiles == 1:  # the fused route: one launch, no ring, no workspace
        want = 1024 + pl.dtiles * (ia.BQ + ia.BKEY) * ia.KTB + pl.dch * ia.BKEY
        assert pl.route == "fused" and (pl.stages, pl.workspace) == (0, 0)
        assert pl.smem == want <= ia.MAX_SMEM // 2
        return
    # the block's shared memory: alignment, the Q tile, the ring, the barriers
    want = (1024 + pl.dtiles * ia.BQ * ia.KTB
            + pl.stages * (pl.dtiles * ia.BKEY * ia.KTB + pl.dch * ia.BKEY)
            + 16 * (pl.stages + 1))
    assert pl.route == "tma" and 2 <= pl.stages <= ia.MAX_STAGES
    assert pl.smem == want <= ia.MAX_SMEM
    # two blocks an SM wherever half the shared memory holds two stages
    if ia._smem(pl.dtiles, pl.dch, 2) <= ia.MAX_SMEM // 2:
        assert pl.smem <= ia.MAX_SMEM // 2
    # the workspace: Q, K and V^T, 256-aligned, each region large enough
    assert pl.k_off % 256 == 0 and pl.v_off % 256 == 0
    assert pl.k_off >= b * nq * pl.dp and pl.v_off - pl.k_off >= b * nk * pl.dp
    assert pl.workspace - pl.v_off >= b * pl.dp * pl.nkp


@pytest.mark.parametrize("b,nq,nk,d", _shapes())
def test_plan_covers_every_int8_attn_and_card_shape(b, nq, nk, d):
    for dtype in DTYPES:
        _check_plan(ia.plan(b, nq, nk, d, dtype), b, nq, nk, d)


def test_plan_refuses_shapes_the_kernel_does_not_take():
    for args in ((2, 300, 300, 513), (2, 0, 300, 64), (0, 30, 30, 64), (2, 30, 0, 64)):
        with pytest.raises(ValueError):
            ia.plan(*args, torch.bfloat16)
    with pytest.raises(TypeError):
        ia.plan(2, 30, 30, 64, torch.float16)
    # the routes of S's shapes: one key tile (N = 76) fused, the rest by TMA
    assert ia.plan(64, 76, 76, 64, torch.bfloat16).route == "fused"
    assert ia.plan(8, 1216, 1216, 32, torch.bfloat16).route == "tma"


def test_instances_header_compiles_every_chunk_width():
    text = ia.instances_header()
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in text
    for n in ia.DCHS:
        assert f"template <> struct WgmmaRS<{n}>" in text
        assert f"m64n{n}k32.s32.s8.s8" in text
    assert text.count("X(") == len(ia.DCHS)
    # every chunk width a head dim up to MAX_HEAD_DIM can give is compiled
    assert {ia.plan(1, 64, 64, d, torch.float32).dch
            for d in range(1, ia.MAX_HEAD_DIM + 1)} == set(ia.DCHS)
