"""Kernels A and B's instance plan (`s2m2_torch.ops.flash_attention.plan`),
the instance header the build generates from it for
`csrc/scanline_attention.cu`, and the packed cross attention's CPU path.
No JAX, no card."""
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from s2m2_torch.ops import _build
from s2m2_torch.ops import flash_attention as fa

SOURCE = Path(fa.__file__).resolve().parents[1] / "csrc" / "scanline_attention.cu"
MAX_SHARED_BYTES = 232448  # dynamic shared memory one H100 block may use


def test_build_compiles_the_plan_table(tmp_path, monkeypatch):
    """The header the build writes for the kernel lists exactly the plan's
    instances, the source dispatches through it, and an unchanged table
    leaves the header (and so the built library) alone."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    newest = _build._write_generated("scanline_attention")
    header = tmp_path / "scanline_attention_instances.h"
    text = header.read_text()
    assert text == fa.instances_header()
    got = {}
    for macro, dtype in (("S2M2_TF32_INSTANCES", torch.float32),
                         ("S2M2_BF16_INSTANCES", torch.bfloat16)):
        line = next(ln for ln in text.splitlines() if ln.startswith(f"#define {macro}(X) "))
        got[dtype] = {int(x[0]): tuple(int(v) for v in x[1:])
                      for x in (m.split(", ") for m in re.findall(r"X\(([\d, ]+)\)", line))}
    assert got == fa._INSTANCES
    src = SOURCE.read_text()
    assert '#include "scanline_attention_instances.h"' in src
    assert "S2M2_TF32_INSTANCES(S2M2_CASE)" in src and "S2M2_BF16_INSTANCES(S2M2_CASE)" in src
    os.utime(header, (1, 1))
    assert _build._write_generated("scanline_attention") == max(1, SOURCE.stat().st_mtime)
    assert newest >= SOURCE.stat().st_mtime
    assert _build._generated_headers("sinkhorn_ot") == {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_head_dim_runs_on_tensor_cores(dtype):
    """Every D from 1 to 384: a tensor-core path, D padded to the smallest
    compiled multiple of the k-step (16 in bf16, 8 in TF32), and a block
    that fits the H100's 232,448 bytes of shared memory."""
    step = 16 if dtype == torch.bfloat16 else 8
    dps = sorted(fa._INSTANCES[dtype])
    for d in range(1, fa.MAX_HEAD_DIM + 1):
        p = fa.plan(dtype, d)
        assert p.path == ("tensor core bf16" if dtype == torch.bfloat16 else "split TF32")
        assert p.dp >= d and p.dp % step == 0
        assert p.dp == min(x for x in dps if x >= d)
        assert p.bq == 16 * p.mt * p.warps // p.wn and p.bq in (64, 128)
        red = p.warps * p.mt * 16 * p.bk * 4 if p.wn > 1 else 0
        assert p.smem == (p.bq + 2 * p.stages * p.bk) * (p.dp * dtype.itemsize + 16) + red
        assert p.smem <= MAX_SHARED_BYTES


def test_plan_rejects_what_no_instance_runs():
    with pytest.raises(TypeError):
        fa.plan(torch.float16, 64)
    for d in (0, fa.MAX_HEAD_DIM + 1):
        with pytest.raises(ValueError):
            fa.plan(torch.bfloat16, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_cross_attention_is_both_directions_in_one_tensor(dtype):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((6, 19, 24)).astype(np.float32)).to(dtype)
               for _ in range(3))
    _build.reset_launch_counts()
    got = fa.scanline_cross_attention_packed(q, k, v)
    ox, oy = fa.scanline_cross_attention(q[:3], k[:3], v[:3], q[3:], k[3:], v[3:])
    assert got.shape == q.shape and got.dtype == dtype
    assert torch.equal(got, torch.cat([ox, oy]))
    assert torch.equal(got[:3], fa.scanline_attention_plain(q[:3], k[3:], v[3:]))
    assert all(n == 0 for n in _build.launch_counts.values())
    with pytest.raises(ValueError):
        fa.scanline_cross_attention_packed(q[:5], k[:5], v[:5])
