"""Kernel D's instance choice (`ops.fused_block.plan`) and the table the
build compiles, checked on the CPU: every fused block shape of the published
variants at 1216x1024 and of the card tests gets a valid instance, XL's two
shapes take the wgmma + TMA path, and the generated header lists exactly the
table's instances."""
import pytest
import torch

from s2m2_torch.config import VARIANTS, get_config
from s2m2_torch.ops import fused_block as fb

DTYPES = (torch.bfloat16, torch.float32)
# (pairs, W, C, heads, dim_expansion) of test_fused_block_kernel_matches_plain_on_card
CARD_CASES = [(3, 24, 16, 4, 1), (2, 33, 48, 4, 1), (2, 40, 48, 2, 1), (2, 70, 128, 1, 1),
              (2, 50, 384, 2, 1), (2, 65, 384, 1, 1), (3, 20, 8, 1, 2), (2, 9, 512, 4, 1),
              (2, 304, 384, 1, 1), (2, 152, 384, 2, 1), (2, 17, 20, 5, 1), (2, 24, 12, 3, 2)]


def _fused_shapes(model, h=1024, w=1216):
    """(W, C, E, heads) of every scanline block the fused route takes in one
    forward at (h, w): the MRT's 1/4, 1/8 and 1/16 scales where C, E <= 512."""
    cfg = get_config(model)
    h4, w4, c, nh = h // 4, w // 4, cfg.feature_channels, cfg.num_heads
    out = []
    for ws, ds, heads in ((w4, c, nh), (w4 // 2, c, 2 * nh), (w4 // 4, 2 * c, 4 * nh)):
        e = cfg.dim_expansion * ds
        if fb.supports(ds, e):
            out.append((ws, ds, e, heads))
    return out


def _check_plan(pl, w, c, e, heads, dtype):
    esz = dtype.itemsize
    pr, nc, bkv, inst = fb._INSTANCES[dtype]
    hd = e // heads
    assert (pl.dpw, pl.passes) in inst and pl.pr == pr
    assert pl.hdp == nc * pl.dpw * pl.passes >= hd
    chunks = -(-max(c, e, pl.hdp) * esz // 128)
    kv_stages = -(-(-(-pl.hdp * esz // 128)) // (fb.STAGE_BYTES // (bkv * 128)))
    assert kv_stages <= pl.stages <= fb.MAX_STAGES
    # the layout csrc/fused_basic_attn_block.cu's `Layout` computes
    want = (1024 + pl.stages * fb.STAGE_BYTES + 2 * pr * chunks * 128 + fb.STAGING
            + (2 * fb.MAX_STAGES + 2) * 8)
    assert pl.smem == want <= fb.MAX_SMEM
    assert pl.tma == ((c * esz) % 16 == 0 and (e * esz) % 16 == 0)


@pytest.mark.parametrize("model", sorted(VARIANTS))
def test_plan_covers_every_variant_at_1216x1024(model):
    shapes = _fused_shapes(model)
    assert shapes, f"{model} has no fused block shape"
    for w, c, e, heads in shapes:
        for dtype in DTYPES:
            _check_plan(fb.plan(w, c, e, heads, dtype), w, c, e, heads, dtype)


def test_xl_shapes_take_wgmma_and_tma():
    assert sorted(_fused_shapes("XL")) == [(152, 384, 384, 2), (304, 384, 384, 1)]
    for w, c, e, heads in _fused_shapes("XL"):
        pl = fb.plan(w, c, e, heads, torch.bfloat16)
        assert pl.path == "wgmma" and pl.tma and pl.hdp == e // heads
        assert fb.plan(w, c, e, heads, torch.float32).path == "split TF32"


@pytest.mark.parametrize("pairs,w,c,heads,exp", CARD_CASES)
def test_plan_covers_card_cases(pairs, w, c, heads, exp):
    for dtype in DTYPES:
        _check_plan(fb.plan(w, c, c * exp, heads, dtype), w, c, c * exp, heads, dtype)
    # bf16 rows that are not a multiple of 16 bytes take the gathered tiles
    assert fb.plan(w, c, c * exp, heads, torch.bfloat16).tma == (c % 8 == 0)


def test_plan_covers_every_head_dim():
    """Every head dim 1..512 (one head), and odd widths, in both dtypes."""
    for dtype in DTYPES:
        for e in range(1, 513):
            _check_plan(fb.plan(9, min(e, 512), e, 1, dtype), 9, min(e, 512), e, 1, dtype)
        for c, e, heads in ((20, 40, 5), (15, 45, 3), (512, 512, 2), (7, 14, 7)):
            _check_plan(fb.plan(33, c, e, heads, dtype), 33, c, e, heads, dtype)


def test_plan_rejects():
    with pytest.raises(ValueError):
        fb.plan(24, 520, 520, 1, torch.bfloat16)
    with pytest.raises(ValueError):
        fb.plan(24, 16, 16, 3, torch.bfloat16)
    with pytest.raises(TypeError):
        fb.plan(24, 16, 16, 1, torch.float16)


def test_header_lists_the_table():
    text = fb.instances_header()
    for dtype, (pr, nc, bkv, inst) in fb._INSTANCES.items():
        code = fb._DTYPES[dtype]
        for d, n in inst:
            assert f"X({code}, {d}, {n})" in text
        suffix = "BF16" if dtype == torch.bfloat16 else "F32"
        assert f"#define S2M2_D_PR_{suffix} {pr}" in text
        assert f"#define S2M2_D_NC_{suffix} {nc}" in text
        assert f"#define S2M2_D_BKV_{suffix} {bkv}" in text
    assert text.count("X(") == sum(len(v[3]) for v in fb._INSTANCES.values())
    assert "struct Wgmma<__nv_bfloat16, 128>" in text
