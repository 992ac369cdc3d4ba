"""Float32 convolutions by split TF32 on the tensor cores: kernel G.

`conv_tf32x3(x, w_split, bias, kh, kw, ph, pw)` is conv2d(x, w) + bias
with stride 1, dilation 1 and groups 1 on an NCHW float32 input, where
`w_split = split_weight(w)` holds the weight split into its TF32 big and
small parts, laid out (kh * kw, 2, N, Cp) with the channels innermost and
zero-padded to Cp, a multiple of 4. Each product is three TF32 products,
small * big, big * small, big * big, summed in float32: a float32 result
(big is x rounded to TF32, to nearest with ties away as `cvt.rna`; small
is x - big rounded the same way). On a CUDA tensor the wrapper launches
`csrc/conv_tf32x3.cu` (and counts the launch: `conv_tf32x3` for a spatial
kernel, `conv1x1_tf32x3` for a 1x1 one, which runs on the kernel's flat
path, `s2m2_conv1x1_tf32x3`); on a CPU tensor it runs the
plain version beside it, which sums the three products as three float32
convolutions, in another order than the kernel's k-steps. While
torch.export traces, and on meta tensors, the call goes through the custom
op `s2m2_torch::conv_tf32x3` (ops/library.py). G has no backward: a call
that autograd would record raises (ops/_grad.py), and `route` never sends
one.

`route(x, weight, stride, padding)` is the rule `models/layers.py Conv`
follows: G takes a float32 CUDA input that no gradient is wanted for,
with a float32 weight and stride 1 (the model's convs all have groups 1
and dilation 1), where `plan` accepts the shape; every other conv keeps
F.conv2d (cuDNN on the card). `plan(shape)` is pure Python: it picks the
kernel's instance for a shape, a spatial one (`_INSTANCES`: tiles of 8 MT
output rows x 16 columns) or, for a 1x1 kernel, a flat one
(`_FLAT_INSTANCES`: tiles of 128 MT pixels taken flat over H W), by the
weight's shape alone; or it refuses the shapes the kernel does not take (a
kernel above 3 x 3, a 1x1 with padding, a row of pixels, or for a 1x1 an
image's plane, that is not a multiple of 16 bytes, which TMA cannot
stride) or that gain nothing on the tensor cores (fewer than 16 input or
32 output channels, where a tile would be mostly zeros).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build
from ._grad import refuse_grad, wants_grad

SMS = 132         # the H100's SMs: the persistent grid's width, in the plan's cost
MAX_SMEM = 232448  # shared bytes a block may use on the H100
MIN_CIN = 16
MIN_COUT = 32
# (MT, N tile) -> B stages: the one table of instances. A tile is 8 MT rows
# x 16 columns of output pixels by the N tile of output channels, two
# consumer warpgroups of MT 64-row accumulators each; a B stage holds both
# parts of a 32-channel k tile of one tap. The build compiles exactly these
# into csrc/conv_tf32x3.cu (through `instances_header`)
_INSTANCES = {(1, 128): 4, (2, 64): 6, (1, 64): 8}
# the relative rate of each instance's tiles (larger tiles load less a
# product), which the plan weighs against the rounds of the persistent grid
_RATE = {(1, 128): 1.0, (2, 64): 0.85, (1, 64): 0.75}
# The flat instances of 1x1 convs, (MT, N tile) -> stages. A tile is 128 MT
# pixels taken flat over H W (each consumer warpgroup's 64 MT one TMA box
# of 64 MT + 8 pixels x 32 channels) by the N tile; a stage holds a
# 32-channel chunk's two boxes and both weight parts; each warpgroup's
# output box (N tile x 64 MT pixels) sits beside the stages
_FLAT_INSTANCES = {(1, 128): 3, (2, 64): 3, (1, 64): 5}
_FLAT_RATE = {(1, 128): 1.0, (2, 64): 0.95, (1, 64): 0.75}


class Plan(NamedTuple):
    """The instance for one shape: MT, the N tile, the B stages (the ring's
    stages on the flat path), the output tiles and the rounds of the
    persistent grid they take, and whether it is a flat instance."""
    mt: int
    bn: int
    sb: int
    tiles: int
    rounds: int
    flat: bool = False


def smem_bytes(mt, bn, sb):
    """Shared bytes of one block (`Geo<MT, BN, SB>::BYTES` in the .cu): two
    activation boxes of (16 + 8) x (8 MT + 3) pixels x 32 channels, SB
    stages of both weight parts, the barriers and the alignment slack."""
    return 1024 + 2 * 32 * 24 * (8 * mt + 3) * 4 + sb * 2 * bn * 128 + 16 * (2 + sb)


def flat_smem_bytes(mt, bn, sb):
    """Shared bytes of one flat block (`FlatGeo<MT, BN, SB>::BYTES`): SB
    stages of two boxes of (64 MT + 8) pixels x 32 channels and both weight
    parts, two output boxes of BN channels x 64 MT pixels, the barriers and
    the alignment slack."""
    return (1024 + sb * (2 * 32 * (64 * mt + 8) * 4 + 2 * bn * 128) + 2 * bn * 64 * mt * 4
            + 16 * sb)


def out_hw(h, w, kh, kw, ph, pw):
    return h + 2 * ph - kh + 1, w + 2 * pw - kw + 1


def plan(shape) -> Optional[Plan]:
    """The instance that runs a conv of `shape` = (b, c, h, w, n, kh, kw, ph,
    pw) (input (b, c, h, w), n output channels, kernel (kh, kw), padding
    (ph, pw), stride 1), or None where G does not take it: a flat instance
    for a 1x1 kernel, a spatial one otherwise. Among the instances, the
    least rounds of the grid x tile work / rate, the larger tile on a
    tie."""
    b, c, h, w, n, kh, kw, ph, pw = shape
    if c < MIN_CIN or n < MIN_COUT or b < 1:
        return None
    if kh == kw == 1:
        if ph or pw or h < 1 or w < 1 or h * w % 4:
            return None
        return _cheapest(_FLAT_INSTANCES, _FLAT_RATE, True,
                         lambda mt, bn: b * math.ceil(h * w / (128 * mt)) * math.ceil(n / bn))
    ho, wo = out_hw(h, w, kh, kw, ph, pw)
    if kh > 3 or kw > 3 or ph < 0 or pw < 0 or w % 4 or ho < 1 or wo < 1:
        return None
    return _cheapest(_INSTANCES, _RATE, False, lambda mt, bn: b * math.ceil(ho / (8 * mt))
                     * math.ceil(wo / 16) * math.ceil(n / bn))


def _cheapest(instances, rate, flat, tiles_of) -> Plan:
    best = None
    for (mt, bn), sb in instances.items():
        tiles = tiles_of(mt, bn)
        rounds = math.ceil(tiles / SMS)
        key = (rounds * mt * bn / rate[(mt, bn)], -mt * bn)
        if best is None or key < best[0]:
            best = (key, Plan(mt, bn, sb, tiles, rounds, flat))
    return best[1]


def route(x, weight, stride=1, padding=(0, 0)) -> Optional[Plan]:
    """G's plan for a conv (groups 1, dilation 1, as every Conv of the
    model), or None where it stays on F.conv2d: only a float32 CUDA input
    with a float32 weight, no gradient wanted and stride 1 takes G."""
    if not (x.is_cuda and x.dtype == torch.float32 and weight.dtype == torch.float32
            and x.dim() == 4 and weight.dim() == 4):
        return None
    if wants_grad(x, weight) or stride not in (1, (1, 1)):
        return None
    b, c, h, w = x.shape
    n, cin, kh, kw = weight.shape
    if cin != c:
        return None
    return plan((b, c, h, w, n, kh, kw, *padding))


def conv_flops(y, weight):
    """2 x outputs x (C kh kw): the operations of a conv that gave y."""
    return 2 * y.numel() * math.prod(weight.shape[1:])


def tf32_round(x):
    """float32 x rounded to TF32's 10 mantissa bits, to nearest with ties
    away (cvt.rna.tf32.f32; the kernel's integer add and mask)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    """(big, small): big = tf32_round(x), small = tf32_round(x - big)."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def split_weight(weight):
    """An OIHW float32 weight (N, C, kh, kw) as G reads it: (kh * kw, 2, N,
    Cp), part 0 big and part 1 small, channels zero-padded to Cp (C rounded
    up to 4, so a row is a multiple of 16 bytes)."""
    n, c, kh, kw = weight.shape
    cp = (c + 3) // 4 * 4
    big, small = tf32_split(weight.float())
    parts = torch.stack((big, small)).permute(3, 4, 0, 1, 2)  # (kh, kw, 2, N, C)
    return F.pad(parts, (0, cp - c)).reshape(kh * kw, 2, n, cp).contiguous()


def _parts(w_split, c, kh, kw):
    """The OIHW (big, small) weights of a split weight."""
    taps, _, n, _ = w_split.shape
    w = w_split[..., :c].reshape(kh, kw, 2, n, c).permute(2, 3, 4, 0, 1)
    return w[0], w[1]


def conv_tf32x3_plain(x, w_split, bias, kh, kw, ph, pw):
    """The plain version of `conv_tf32x3`: the input split as the kernel
    splits it, the three products as three float32 convolutions (small *
    big, big * small, big * big, added in that order), then the bias."""
    _check(x, w_split, bias, kh, kw, ph, pw)
    wb, ws = _parts(w_split, x.shape[1], kh, kw)
    xb, xs = tf32_split(x)
    y = F.conv2d(xs, wb, padding=(ph, pw))
    y = y + F.conv2d(xb, ws, padding=(ph, pw))
    y = y + F.conv2d(xb, wb, padding=(ph, pw))
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)


def out_shape(x, w_split, kh, kw, ph, pw):
    b, _, h, w = x.shape
    return (b, w_split.shape[2], *out_hw(h, w, kh, kw, ph, pw))


def _check(x, w_split, bias, kh, kw, ph, pw):
    """Raise on what the kernel does not take; the shape checks the custom
    op's fake implementation shares."""
    if x.dim() != 4 or w_split.dim() != 4:
        raise ValueError(f"conv_tf32x3: x (B, C, H, W) and w_split (taps, 2, N, Cp), got "
                         f"{tuple(x.shape)} and {tuple(w_split.shape)}")
    b, c, h, w = x.shape
    taps, two, n, cp = w_split.shape
    if taps != kh * kw or two != 2 or cp < c or cp % 4 or not 1 <= kh <= 3 \
            or not 1 <= kw <= 3:
        raise ValueError(f"conv_tf32x3: w_split {tuple(w_split.shape)} is no split "
                         f"{kh}x{kw} weight of {c} channels")
    if x.dtype != torch.float32 or w_split.dtype != torch.float32 or w_split.device != x.device:
        raise ValueError("conv_tf32x3: float32 x and w_split on one device")
    if bias is not None and (bias.shape != (n,) or bias.dtype != torch.float32
                             or bias.device != x.device):
        raise ValueError(f"conv_tf32x3: bias must be float32 ({n},) on {x.device}")
    ho, wo = out_hw(h, w, kh, kw, ph, pw)
    if ph < 0 or pw < 0 or ho < 1 or wo < 1:
        raise ValueError(f"conv_tf32x3: padding {(ph, pw)} of a {h}x{w} input")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"conv_tf32x3: unsupported device {x.device}")


def _entry():
    return _build.entry("conv_tf32x3", "s2m2_conv_tf32x3",
                        (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 14)


def _flat_entry():
    return _build.entry("conv_tf32x3", "s2m2_conv1x1_tf32x3",
                        (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 9)


def _kernel(x, w_split, bias, kh, kw, ph, pw, p=None, grid_cap=0):
    """G's direct launch on a contiguous CUDA x (no gradient), on the flat
    path for a 1x1 kernel; p: the instance, `plan`'s by default; grid_cap >
    0 caps the persistent grid (the card test walks every tile with one
    block)."""
    b, c, h, w = x.shape
    n, cp = w_split.shape[2:]
    if p is None:
        p = plan((b, c, h, w, n, kh, kw, ph, pw))
        if p is None:
            raise ValueError(f"conv_tf32x3: no instance takes {(b, c, h, w, n, kh, kw)}")
    if p.flat != (kh == kw == 1):
        raise ValueError(f"conv_tf32x3: a {'flat' if p.flat else 'spatial'} instance for a "
                         f"{kh}x{kw} kernel")
    if not x.is_contiguous() or not w_split.is_contiguous() or x.data_ptr() % 16 \
            or w_split.data_ptr() % 16:
        raise ValueError("conv_tf32x3: x and w_split must be contiguous, 16-byte aligned")
    out = torch.empty(out_shape(x, w_split, kh, kw, ph, pw), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), w_split.data_ptr(),
            0 if bias is None else bias.contiguous().data_ptr(), out.data_ptr())
    if p.flat:
        _build.call(_flat_entry(), x.device, "conv1x1_tf32x3", *ptrs,
                    b, c, h * w, n, cp, p.mt, p.bn, p.sb, grid_cap)
    else:
        _build.call(_entry(), x.device, "conv_tf32x3", *ptrs,
                    b, c, h, w, n, cp, kh, kw, ph, pw, p.mt, p.bn, p.sb, grid_cap)
    return out


def conv_tf32x3(x, w_split, bias, kh, kw, ph, pw):
    """conv2d(x, w) + bias, stride 1, with w_split = split_weight(w): kernel
    G on a CUDA tensor, its plain version on a CPU one."""
    _check(x, w_split, bias, kh, kw, ph, pw)
    if _build.via_op(x):
        return _build.op("conv_tf32x3")(x, w_split, bias, kh, kw, ph, pw)
    if x.device.type == "cpu":
        return conv_tf32x3_plain(x, w_split, bias, kh, kw, ph, pw)
    refuse_grad("conv_tf32x3", x, w_split)
    return _kernel(x.contiguous(), w_split, bias, kh, kw, ph, pw)


def _wgmma_struct(bn):
    """WgmmaTF32<BN>: one wgmma m64nBNk8 with A's four TF32 registers and B
    from a shared-memory descriptor into BN / 2 float32 accumulators,
    added to them (scale_d 1) or overwriting them (scale_d 0)."""
    regs = bn // 2
    outs = ", ".join(f"%{i}" for i in range(regs))
    cons = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    a = ", ".join(f"%{regs + i}" for i in range(4))
    return (f"template <> struct WgmmaTF32<{bn}> {{\n"
            f"  static __device__ __forceinline__ void mma(float (&d)[{regs}],"
            f" const uint32_t (&a)[4], uint64_t b, int scale_d) {{\n"
            f'    asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 5}, 0;\\n"\n'
            f'                 "wgmma.mma_async.sync.aligned.m64n{bn}k8.f32.tf32.tf32 '
            f'{{{outs}}}, {{{a}}}, %{regs + 4}, p, 1, 1;\\n}}\\n"\n'
            f"                 : {cons}\n"
            f'                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),'
            f' "r"(scale_d));\n'
            f"  }}\n}};\n")


def instances_header() -> str:
    """The C header csrc/conv_tf32x3.cu includes from the build directory:
    `_INSTANCES` and `_FLAT_INSTANCES` as the X-macro lists
    S2M2_CONV_INSTANCES and S2M2_CONV1X1_INSTANCES, X(MT, N tile, stages),
    and the wgmma wrapper of each N tile."""
    lines = ["// Generated from _INSTANCES and _FLAT_INSTANCES in s2m2_torch/ops/conv.py.",
             "#pragma once", "#include <stdint.h>", "template <int BN> struct WgmmaTF32;"]
    lines += [_wgmma_struct(bn) for bn in sorted({bn for _, bn in (*_INSTANCES,
                                                                   *_FLAT_INSTANCES)})]
    for macro, table in (("S2M2_CONV_INSTANCES", _INSTANCES),
                         ("S2M2_CONV1X1_INSTANCES", _FLAT_INSTANCES)):
        cases = " ".join(f"X({mt}, {bn}, {sb})" for (mt, bn), sb in sorted(table.items()))
        lines.append(f"#define {macro}(X) {cases}")
    return "\n".join(lines) + "\n"
