"""Kernel D's plain version and the fused route of the port against the JAX
package's fused block (its Pallas kernel in interpret mode) and against the
port's own unfused block; the MRT's dispatch rule; the wrapper's checks."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from s2m2_torch.models.attention import BasicAttnBlock
from s2m2_torch.ops import _build
from s2m2_torch.ops import fused_block as fb
from s2m2_torch.tools.convert import from_jax

torch.set_num_threads(2)


def _jax_block(seed, c, heads, e):
    """JAX-layout block weights from the JAX package's init, and the port's
    BasicAttnBlock holding the same weights."""
    from s2m2_tpu.models.init import _Rng, _basic_attn_block
    from s2m2_tpu.tools.convert_checkpoint import flatten
    p = _basic_attn_block(_Rng(seed), c, heads, e)
    blk = BasicAttnBlock(c, heads, e)
    blk.load_state_dict(from_jax({k: np.asarray(v) for k, v in flatten(p).items()}))
    return p, blk


def _nchw(z):
    """(2B, H, W, C) numpy -> (2B, C, H, W) torch."""
    return torch.from_numpy(np.ascontiguousarray(z.transpose(0, 3, 1, 2)))


# the cases and tolerances of tests/test_fused_block.py: float32 atol 3e-5
# (summation order only); bfloat16 atol 5e-2 (outputs of order 1 rounded
# to 8 mantissa bits, with rounding points matched step by step)
@pytest.mark.parametrize("heads,c,e", [(1, 16, 1), (2, 16, 1), (1, 8, 2)])
def test_plain_matches_pallas_interpret(rng, heads, c, e):
    from s2m2_tpu.ops.fused_block import fused_basic_attn_block as jax_fused
    p, blk = _jax_block(0, c, heads, e)
    z = rng.standard_normal((4, 3, 24, c)).astype(np.float32)  # (2B, H, W, C)
    want = jax_fused(p, jnp.asarray(z), num_heads=heads, interpret=True)
    rows = torch.from_numpy(z.reshape(12, 24, c))
    with torch.inference_mode():
        ox, oy = fb.fused_basic_attn_block_plain(rows[:6], rows[6:], blk.fused_weights(),
                                                 heads)
    got = torch.cat([ox, oy]).numpy().reshape(z.shape)
    np.testing.assert_allclose(got, np.asarray(want), atol=3e-5)


def test_plain_matches_pallas_interpret_bf16(rng):
    from s2m2_tpu.ops.fused_block import fused_basic_attn_block as jax_fused
    p, blk = _jax_block(1, 16, 1, 1)
    z = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    want = jax_fused(p, jnp.asarray(z, jnp.bfloat16), num_heads=1, interpret=True)
    rows = torch.from_numpy(z.reshape(4, 16, 16)).bfloat16()
    with torch.inference_mode():
        got = fb.fused_basic_attn_block(rows, 2, [w.bfloat16() for w in blk.fused_weights()],
                                        1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy().reshape(z.shape),
                               np.asarray(want, np.float32), atol=5e-2)


@pytest.mark.parametrize("heads,e", [(1, 1), (2, 1), (4, 2)])
def test_block_fused_route_matches_unfused(rng, heads, e):
    """The same block and input through both routes, float32 atol 3e-5."""
    _, blk = _jax_block(2, 32, heads, e)
    z = _nchw(rng.standard_normal((2, 3, 10, 32)).astype(np.float32))
    with torch.inference_mode():
        want = blk(z)
        blk.fused = True
        got = blk(z)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5)


def test_mrt_dispatch_routes_by_width(monkeypatch):
    """C = 384 blocks take the fused block, C = 768 blocks stay unfused."""
    from s2m2_torch.models import attention
    from s2m2_torch.models.init import _mrt, _Rng
    from s2m2_torch.models.mrt import StackedMRT
    from s2m2_torch.ops import flash_attention as fa
    from s2m2_torch.tools.convert import flatten

    mrt = StackedMRT([384, 384, 768], 1, 1, fused_block=True)
    state = from_jax(flatten(_mrt(_Rng(0), [384, 384, 768], 1, 1)))
    mrt.load_state_dict({f"uformer_list.0.{k}": v for k, v in state.items()})
    m = mrt.uformer_list[0]
    assert [b.fused for b in (m.enc_attn0, m.enc_attn1, m.enc_attn2,
                              m.dec_attn0, m.dec_attn1, m.dec_attn2)] == \
        [True, True, False, True, True, False]

    calls = {"fused": [], "cross": []}
    plain, cross = fb.fused_basic_attn_block_plain, fa.scanline_cross_attention_packed

    def spy_plain(x, y, w, h):
        calls["fused"].append(x.shape[-1])
        return plain(x, y, w, h)

    def spy_cross(*qkv):
        calls["cross"].append(qkv[0].shape)
        return cross(*qkv)

    monkeypatch.setattr(fb, "fused_basic_attn_block_plain", spy_plain)
    monkeypatch.setattr(attention.fa, "scanline_cross_attention_packed", spy_cross)
    g = np.random.default_rng(0)
    zs = [torch.from_numpy(g.standard_normal((2, c, 8 >> i, 16 >> i)).astype(np.float32))
          for i, c in enumerate((384, 384, 768, 768))]
    with torch.inference_mode():
        out = mrt(*zs)
    assert out.shape == zs[0].shape and torch.isfinite(out).all()
    assert calls["fused"] == [384] * 4  # enc/dec at 1x and 2x
    # unfused: the two C = 768 scanline blocks and the four 2D cross blocks
    assert len(calls["cross"]) == 6


def _weights(c, e, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    shapes = [(e, c), (e, c), (e, c), (e,), (c, e), (e, c), (e,), (c, e), (c,)] * 2
    return [torch.randn(s, generator=g, dtype=dtype) for s in shapes]


def test_cpu_call_counts_no_launch():
    rows = torch.randn(4, 6, 16)
    _build.reset_launch_counts()
    out = fb.fused_basic_attn_block(rows, 2, _weights(16, 16), 2)
    assert out.shape == rows.shape and torch.isfinite(out).all()
    assert all(n == 0 for n in _build.launch_counts.values())


@pytest.mark.parametrize("case", ["c_too_wide", "e_too_wide", "mixed_dtypes",
                                  "non_contiguous", "bad_heads", "odd_rows"])
def test_wrapper_rejects(case):
    rows, right0, weights, heads = torch.randn(4, 6, 16), 2, _weights(16, 16), 2
    if case == "c_too_wide":
        rows, weights = torch.randn(4, 6, 520), _weights(520, 520)
    elif case == "e_too_wide":
        weights = _weights(16, 520)
    elif case == "mixed_dtypes":
        weights[4] = weights[4].bfloat16()
    elif case == "non_contiguous":
        rows = torch.randn(4, 16, 6).transpose(1, 2)
    elif case == "bad_heads":
        heads = 3
    elif case == "odd_rows":
        right0 = 3
    with pytest.raises(ValueError):
        fb.fused_basic_attn_block(rows, right0, weights, heads)
