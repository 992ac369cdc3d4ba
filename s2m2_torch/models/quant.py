"""Static-scale int8 quantization: the port of `s2m2_tpu/models/quant.py`.

Mechanics, as in the JAX package:

- Every qualifying conv/linear input is a "site". The calibration pass and
  the quantized pass walk the forward in the same order, so sites match by
  trace order alone.
- `observe()`: each site records max|x| (or a percentile of |x|); the
  caller turns them into scales amax / 127.
- `quantized(scales)`: each site takes the next scale s_x and computes
  x_q = clip(round(x * float32(1 / s_x)), -127, 127), acc = x_q w_q in
  int32, y = float(acc) * (s_w[n] * s_x) + bias, cast to x's dtype. Weights
  are int8 per output channel, prequantized once (`quantize_model`) or
  quantized inline.
- One shared site for an input that several GEMMs read (q/k/v, the two
  branches of a conv block), the per-head output-projection sites of the
  multi-head scanline blocks, and the int8 residual stream of "int8r".

On CUDA tensors every quantized product is kernel E's two launches
(`ops/int8_gemm.py`): a pack, then a GEMM. A conv whose input has at
least `ig.IMPLICIT_MIN_C` channels packs its input once into an NHWC int8
tensor and runs as an implicit GEMM on it against its weight reordered to
(dy, dx, c) taps (`conv_weight_taps`, cached beside the prequantized
weight); a narrower conv packs explicit im2col rows, in chunks of at most
`MAX_PACK_BYTES`; a linear packs token rows. On CPU tensors the plain
versions run. The state is thread-local, as in the JAX package.

Left out of the port: int8 attention cores (`sdpa_maybe_quantized`, the
`int8_attn` opt-in) and bf16 accumulators (`int8_acc_bf16`), both off by
default in the JAX package, and `linear_heads_maybe_quantized`, which
nothing there calls.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from ..ops import int8_gemm as ig

# One launch's explicit im2col rows (convs with C < ig.IMPLICIT_MIN_C) stay
# below 1 GiB; a larger such site is packed and multiplied in chunks of
# output rows.
MAX_PACK_BYTES = 1 << 30

# Subtrees the JAX package repacks at trace time (s2m2_tpu/models/quant.py
# _REPACKED_PATHS): their weights stay float and quantize inline.
REPACKED_PATHS = (
    "cnn_backbone.conv0",
    "cnn_backbone.conv1_down.0",
    "upsample_mask_1x",
    "upsample_mask_4x_refine",
)

_state = threading.local()


def _ctx():
    s = _state
    if not hasattr(s, "mode"):
        s.mode = None  # None | "observe" | "quantize"
        s.scales = None
        s.cursor = 0
        s.observed = None
        s.aligned = False
        s.skip_fp32 = False
        s.residency = False
        s.percentile = None
        s.log = None
        s.last_log = []
    return s


def active() -> bool:
    return _ctx().mode is not None


def last_log():
    """The records of the last observe/quantized context on this thread:
    {"kind": "gemm_site"} once per quantized GEMM (in both modes), and in
    quantize mode one "pack" or "gemm" record per kernel launch, with its
    shape."""
    return _ctx().last_log


def _log(kind, **rec):
    log = _ctx().log
    if log is not None:
        log.append({"kind": kind, **rec})


_FIELDS = ("mode", "scales", "cursor", "observed", "aligned", "skip_fp32", "residency",
           "percentile", "log")


@contextlib.contextmanager
def _context(**values):
    s = _ctx()
    prev = {k: getattr(s, k) for k in _FIELDS}
    for k, v in values.items():
        setattr(s, k, v)
    s.log = []
    try:
        yield s
    finally:
        s.last_log = s.log
        for k, v in prev.items():
            setattr(s, k, v)


@contextlib.contextmanager
def observe(aligned=False, skip_fp32=False, residency=False, percentile=None):
    """Record each site's max|x| (a 0-d float32 tensor) into the yielded list.

    aligned: the 128-aligned site policy ("int8a"); skip_fp32: leave
    float32-weight GEMMs (the engine's fp32 islands) float; residency: also
    the int8 residual stream sites ("int8r"); percentile: record that
    percentile of |x| instead of the max."""
    with _context(mode="observe", observed=[], aligned=bool(aligned),
                  skip_fp32=bool(skip_fp32), residency=bool(residency),
                  percentile=None if percentile is None else float(percentile)) as s:
        yield s.observed


@contextlib.contextmanager
def quantized(scales, aligned=False, skip_fp32=False, residency=False):
    """Run with static per-site scales, matched by trace order to the
    `observe()` pass (with the same site policies) that produced them."""
    with _context(mode="quantize", scales=[float(v) for v in scales], cursor=0,
                  aligned=bool(aligned), skip_fp32=bool(skip_fp32),
                  residency=bool(residency)) as s:
        yield
        if s.cursor != len(s.scales):
            raise ValueError(
                f"quantized(): consumed {s.cursor} scales but calibration "
                f"recorded {len(s.scales)} sites — forward paths diverged")


def _quantizable(k_in, cout, cin, aligned=None) -> bool:
    """Enough reduction depth (>= 16) and outputs (>= 8); under the aligned
    policy also channel counts that are multiples of 128."""
    if not (k_in >= 16 and cout >= 8):
        return False
    if aligned is None:
        s = _ctx()
        aligned = s.aligned if s.mode is not None else False
    return not aligned or (cin % 128 == 0 and cout % 128 == 0)


def _percentile(v, p):
    """jnp.percentile(v, p) with its default linear interpolation, in
    float32 as JAX computes it; `kthvalue` takes any size (torch.quantile
    refuses more than 2**24 elements)."""
    f32 = torch.float32
    n = v.numel()
    q = torch.tensor(p, dtype=f32) / torch.tensor(100.0, dtype=f32)
    q = q * (torch.tensor(float(n), dtype=f32) - 1)
    low, high = torch.floor(q), torch.ceil(q)
    high_w = q - low
    low_w = 1 - high_w
    top = torch.tensor(float(n), dtype=f32) - 1
    lo = int(torch.clamp(low, torch.zeros((), dtype=f32), top))
    hi = int(torch.clamp(high, torch.zeros((), dtype=f32), top))
    lo_v = torch.kthvalue(v, lo + 1).values
    hi_v = torch.kthvalue(v, hi + 1).values
    return lo_v * low_w.to(v.device) + hi_v * high_w.to(v.device)


def _record_amax(x):
    s = _ctx()
    ax = x.float().abs()
    if s.percentile is None:
        s.observed.append(ax.amax())
    else:
        s.observed.append(_percentile(ax.reshape(-1), s.percentile))


def _next_scale():
    s = _ctx()
    if s.cursor >= len(s.scales):
        raise ValueError(
            "quantized(): forward hit more GEMM sites than calibration "
            "recorded — forward paths diverged")
    v = s.scales[s.cursor]
    s.cursor += 1
    return max(v, 1e-8)


# ---------------------------------------------------------------- weights

def quantize_weight(w2d):
    """Per-row (output channel) symmetric int8 of an (N, K) weight: returns
    (w_q (N, Kp) int8, zero-padded to Kp, s_w (N,) float32)."""
    wf = w2d.float()
    s_w = torch.clamp(wf.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    w_q = torch.clamp(torch.round(wf / s_w), -127.0, 127.0)
    k = w_q.shape[1]
    return (F.pad(w_q, (0, ig.k_padded(k) - k)).to(torch.int8).contiguous(),
            s_w.reshape(-1).contiguous())


def dequantize(qw, k, dtype):
    """The (N, k) float weight a prequantized (w_q, s_w) stands for."""
    w_q, s_w = qw
    return (w_q[:, :k].float() * s_w[:, None]).to(dtype)


def prequant_of(mod):
    """(w_q, w_scale) of a module `quantize_model` prequantized, else None."""
    w_q = getattr(mod, "w_q", None)
    return None if w_q is None else (w_q, mod.w_scale)


def conv_taps(w_q, cin, kh, kw):
    """The implicit GEMM's weight of a conv with `cin` inputs, or None for a
    conv that keeps the explicit im2col rows (or a 1x1 one, whose (N, Kp)
    weight already is in tap order)."""
    if not ig.implicit(cin) or kh * kw == 1:
        return None
    return ig.conv_weight_taps(w_q, cin, kh, kw)


def _is_repacked(name):
    return any(name == p or name.startswith(p + ".") for p in REPACKED_PATHS)


def quantize_model(model, aligned=False, skip_fp32=False):
    """Prequantize every qualifying Conv/Linear weight of `model` once (the
    port of `quantize_params_tree`): the module gains non-persistent
    buffers `w_q` ((N, Kp) int8, the OIHW or (out, in) weight flattened to
    (N, K) and zero-padded) and `w_scale` ((N,) float32), and a conv that
    runs as an implicit GEMM also `w_q_taps` (`conv_taps`), so the weight is
    reordered once and not per request. Repacked subtrees,
    small heads and, with skip_fp32, float32 weights stay float. Returns
    the number of modules prequantized."""
    count = 0
    for name, mod in model.named_modules():
        if not getattr(mod, "int8_prequantizable", False) or _is_repacked(name):
            continue
        w = mod.weight
        if skip_fp32 and w.dtype == torch.float32:
            continue
        cout, cin = w.shape[0], w.shape[1]
        if _quantizable(w[0].numel(), cout, cin, aligned):
            w_q, s_w = quantize_weight(w.detach().reshape(cout, -1))
            mod.register_buffer("w_q", w_q, persistent=False)
            mod.register_buffer("w_scale", s_w, persistent=False)
            if w.dim() == 4:
                taps = conv_taps(w_q, cin, w.shape[2], w.shape[3])
                if taps is not None:
                    mod.register_buffer("w_q_taps", taps, persistent=False)
            count += 1
    return count


def strip_model(model):
    """Drop the prequantized weights of `quantize_model`."""
    for mod in model.modules():
        for key in ("w_q", "w_scale", "w_q_taps"):
            mod._buffers.pop(key, None)


def prequantize_linear(mod):
    """Full-weight quantization of a Linear whose output is sliced per head
    (the multi-head scanline blocks), in observe and quantize modes alike,
    gated by the full weight's shape (s2m2_tpu quant.py:404). Returns the
    module's own prequantization if it has one, else (w_q, s_w) or None."""
    s = _ctx()
    qw = prequant_of(mod)
    if s.mode is None or qw is not None:
        return qw
    cout, cin = mod.weight.shape
    if not _quantizable(cin, cout, cin):
        return None
    if s.skip_fp32 and mod.weight.dtype == torch.float32:
        return None
    return quantize_weight(mod.weight.detach())


# ---------------------------------------------------------------- sites

class SharedQuantInput:
    """An activation read by several GEMMs: one calibration site, one
    scale, and one packed int8 copy per layout that reads it (the NHWC
    tensor serves every implicit conv geometry)."""
    __slots__ = ("x", "scale", "packs")

    def __init__(self, x, scale=None):
        self.x = x
        self.scale = scale
        self.packs = {}


def share_gemm_input(x):
    """Mark x as a multi-GEMM input (one site). Identity outside a quant
    context."""
    s = _ctx()
    if s.mode is None:
        return x
    if s.mode == "observe":
        _record_amax(x)
        return SharedQuantInput(x)
    return SharedQuantInput(x, _next_scale())


def unwrap(x):
    return x.x if isinstance(x, SharedQuantInput) else x


class ResidualInt8:
    """A residual-stream tensor held as int8 rows and a per-tensor scale
    (the "int8r" policy), until `residual_load` gives it back in `dtype`."""
    __slots__ = ("q", "scale", "dtype", "shape")

    def __init__(self, q, scale, dtype, shape):
        self.q = q
        self.scale = scale
        self.dtype = dtype
        self.shape = shape


def residual_store(z):
    """One site under the int8r policy (identity otherwise): records z's
    amax, or quantizes z through kernel E's pack."""
    s = _ctx()
    if s.mode is None or not s.residency:
        return z
    if s.mode == "observe":
        _record_amax(z)
        return z
    s_x = _next_scale()
    return ResidualInt8(_pack(z, ig.inv_scale(s_x), None), s_x, z.dtype, z.shape)


def residual_load(z):
    """Dequantize a ResidualInt8 back to its float dtype; identity on plain
    tensors."""
    if isinstance(z, ResidualInt8):
        c = z.shape[-1]
        y = z.q[:, :c].float() * torch.tensor(z.scale, dtype=torch.float32)
        return y.to(z.dtype).reshape(z.shape)
    return z


def _rows_view(x):
    """x as the pack kernel takes token rows (copied only if it must be)."""
    if x.is_contiguous() or (x.dim() == 3 and x.stride(2) == 1):
        return x
    return x.contiguous()


def _pack(x, inv, geom, rows=None):
    """quantize_pack of x (a tensor or a SharedQuantInput, whose packs are
    kept per layout), logging the launch. geom None: token rows; "nhwc":
    the NHWC int8 tensor of an implicit conv; a conv geometry: explicit
    im2col rows (rows[0]:rows[1] of them when given)."""
    if isinstance(x, SharedQuantInput) and rows is None:
        q = x.packs.get(geom)
        if q is None:
            q = x.packs[geom] = _pack(x.x, inv, geom)
        return q
    x = unwrap(x)
    if geom == "nhwc":
        x = x.contiguous()
        q = ig.quantize_pack(x, inv, nhwc=True)
        _log("pack", layout="nhwc", rows=q.shape[0] * q.shape[1] * q.shape[2],
             k=x.shape[1], kp=q.shape[3], conv=None, in_shape=tuple(x.shape),
             dtype=str(x.dtype))
        return q
    x = x.contiguous() if geom is not None else _rows_view(x)
    q = ig.quantize_pack(x, inv, conv=geom, rows=rows)
    _log("pack", layout="rows" if geom is None else "im2col", rows=q.shape[0],
         k=(x.shape[-1] if geom is None else x.shape[1] * geom[0] * geom[1]),
         kp=q.shape[1], conv=geom, in_shape=tuple(x.shape), dtype=str(x.dtype))
    return q


def _gemm(a, k, w_q, s_w, s_x, bias, dtype, out=None, m_base=0, conv=None):
    y = ig.int8_gemm(a, w_q, s_w, s_x, bias, dtype, out=out, m_base=m_base, conv=conv)
    m = a.shape[0] if conv is None else y.shape[0] * y.shape[2] * y.shape[3]
    _log("gemm", m=m, n=w_q.shape[0], k=k, kp=w_q.shape[1], out=str(dtype),
         nchw=out is not None, conv=conv, a_shape=tuple(a.shape))
    return y


def _int8_product(x, s_x, qw, bias, geom, taps=None):
    xf = unwrap(x)
    inv = ig.inv_scale(s_x)
    b32 = None if bias is None else bias.float()
    w_q, s_w = qw
    n = w_q.shape[0]
    if geom is None:
        y = _gemm(_pack(x, inv, None), xf.shape[-1], w_q, s_w, s_x, b32, xf.dtype)
        return y.reshape(*xf.shape[:-1], n)
    b, c, h, w = xf.shape
    kh, kw = geom[:2]
    k = c * kh * kw
    ho, wo = ig.conv_out_hw(h, w, geom)
    out = torch.empty((b, n, ho, wo), dtype=xf.dtype, device=xf.device)
    if ig.implicit(c):  # one NHWC pack and one implicit GEMM
        if kh * kw > 1 and taps is None:
            taps = conv_taps(w_q, c, kh, kw)
        return _gemm(_pack(x, inv, "nhwc"), k, w_q if kh * kw == 1 else taps, s_w, s_x,
                     b32, xf.dtype, out=out, conv=geom)
    m = b * ho * wo
    step = max(128, MAX_PACK_BYTES // w_q.shape[1] // 128 * 128)
    if m <= step:
        return _gemm(_pack(x, inv, geom), k, w_q, s_w, s_x, b32, xf.dtype, out=out)
    for m0 in range(0, m, step):
        a = _pack(xf, inv, geom, rows=(m0, min(m, m0 + step)))
        _gemm(a, k, w_q, s_w, s_x, b32, xf.dtype, out=out, m_base=m0)
    return out


def gemm_site(x, weight, bias, qw, gate, geom=None, taps=None):
    """The int8 path of one GEMM, or None for the float path.

    x: a tensor or SharedQuantInput; NCHW when `geom` = (kh, kw, sh, sw, ph,
    pw) is given (a conv, output NCHW), else (..., K) tokens. weight: the
    float (N, K) GEMM weight, K in (c, kh, kw) order; qw: its
    prequantization (w_q, s_w) or None (then quantized inline); gate: the
    (k_in, cin, cout) shape that decides whether an un-prequantized weight
    is a site. taps: the prequantized implicit-conv weight (`conv_taps`),
    if the caller has it."""
    s = _ctx()
    prequant = qw is not None
    if s.mode is None or not (prequant or _quantizable(gate[0], gate[2], gate[1])):
        return None
    if s.skip_fp32 and not prequant and weight.dtype == torch.float32:
        return None  # fp32-island head (engine cast policy): stays float
    _log("gemm_site")
    if s.mode == "observe":
        if not isinstance(x, SharedQuantInput):
            _record_amax(x)
        return None
    s_x = x.scale if isinstance(x, SharedQuantInput) else _next_scale()
    if qw is None:
        qw = quantize_weight(weight)
    return _int8_product(x, s_x, qw, bias, geom, taps)


def conv_maybe_quantized(x, mod):
    """int8 path of a `layers.Conv` (OIHW weight, padding k // 2 unless
    given), or None."""
    cout, cin, kh, kw = mod.weight.shape
    gate = mod.site_gate or (kh * kw * cin, cin, cout)
    ph, pw = (kh // 2, kw // 2) if mod.padding is None else (mod.padding, mod.padding)
    return gemm_site(x, mod.weight.reshape(cout, -1), mod.bias, prequant_of(mod), gate,
                     (kh, kw, mod.stride, mod.stride, ph, pw),
                     getattr(mod, "w_q_taps", None))


def conv_transpose_maybe_quantized(x, mod):
    """int8 path of a `layers.ConvT` whose JAX counterpart is a site: the
    mask heads, which the JAX package runs as packed convolutions
    (packing.pack_convT2x2 / pack_convT3x3 / pack_pointwise). A 2x2
    stride-2 one is a 1x1 conv to the four phases' channels, with a weight
    scale per (phase, channel) as the packed weight gets; a stride-1 one
    is a conv with the flipped kernel."""
    if mod.site_gate is None or not active():
        return None
    cin, cout, kh, kw = mod.weight.shape
    w = mod.weight
    if mod.stride == 2 and kh == kw == 2 and mod.padding == 0:
        w2d = w.permute(2, 3, 1, 0).reshape(4 * cout, cin)  # row (a, b, co)
        bias = None if mod.bias is None else mod.bias.repeat(4)
        y = gemm_site(x, w2d, bias, None, mod.site_gate, (1, 1, 1, 1, 0, 0))
        if y is None:
            return None
        b, _, h, wd = y.shape
        return y.view(b, 2, 2, cout, h, wd).permute(0, 3, 4, 1, 5, 2).reshape(
            b, cout, 2 * h, 2 * wd)
    if mod.stride != 1:
        raise NotImplementedError(f"int8 ConvT site: stride {mod.stride}, kernel "
                                  f"{kh}x{kw} has no packed form")
    p = mod.padding
    w2d = w.flip(2, 3).transpose(0, 1).reshape(cout, cin * kh * kw)
    return gemm_site(x, w2d, mod.bias, None, mod.site_gate,
                     (kh, kw, 1, 1, kh - 1 - p, kw - 1 - p))
