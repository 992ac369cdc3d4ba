"""Band sharding's collectives: the port's substitute for GSPMD.

Under `sharded(mesh, rows)` each rank of a band group runs the forward on
its band of rows (`mesh.band_rows`), and the few primitives that read
across rows consult this module (`models/layers.py`, `models/quant.py`,
`models/unet.py`, `models/mrt.py`):

- `halo(x, top, bottom, fill)`: the `top` rows of the band above and the
  `bottom` rows of the band below, by send/recv over the band group. At the
  image's own edges there is no neighbour, and `fill` supplies what the
  primitive's padding would: "zeros" (a conv), "edge" (replicate padding,
  bilinear's clamp);
- `all_reduce_sum(t)`: float32 sums over the band group (GroupNorm's
  statistics);
- `all_gather_rows(x)`: a band's rows gathered into the full map (the 1/32
  global-attention bottleneck), bands of unequal size included;
- `rows_of(x)`: this band's rows of such a full map.

Rows are axis -2 (NCHW). With no context active every primitive runs its
one-device code, so no collective and no cost reach that path.

Training: each primitive is a `torch.autograd.Function`, whose backward is
the transpose of its collective over the same band group and with the
same finite timeout:

- halo: the gradient of the received rows goes back to the neighbour that
  sent them, which adds it into its own edge rows (the forward's send in
  the other direction); at the image's edges the "edge" fill's rows sum
  into the edge row and the "zeros" fill gives nothing;
- all_reduce_sum: an all-reduce sum of the incoming gradient;
- all_gather_rows: a reduce-scatter, as an all-reduce in float32 of the
  full map's gradient followed by this band's rows (bands of unequal size
  included);
- rows_of: a slice, whose gradient is local (zeros outside the band).

Every rank runs the same forward code, so it creates the same Functions in
the same order, and autograd runs their backwards in the same order on
every rank: a mismatch would deadlock until the group's timeout raises.

Each call counts one collective of its kind, and the bytes this rank
sends; so does each backward that runs (a primitive whose input takes no
gradient has none), under the kind of collective it runs: the gather's
backward counts as an all_reduce. `last_counts()` holds the counts of the last context on
this thread, its backward's included once autograd has run it.
`expected_counts` works the counts of one forward, or of a forward and its
backward, out from the config.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from .mesh import all_reduce, gather_dim

KINDS = ("halo", "all_reduce", "all_gather")

_state = threading.local()


class _Band:
    """The active band context: the mesh, every band's rows at full
    resolution, this rank's index, and the counters."""

    def __init__(self, mesh, rows):
        if len(rows) != mesh.n_band:
            raise ValueError(f"band.sharded: {len(rows)} bands of rows for a mesh of "
                             f"{mesh.n_band} bands")
        self.mesh = mesh
        self.rows = list(rows)
        self.index = mesh.band
        self.n = mesh.n_band
        self.counts = dict.fromkeys(KINDS, 0)
        self.bytes = dict.fromkeys(KINDS, 0)

    def count(self, kind, nbytes):
        self.counts[kind] += 1
        self.bytes[kind] += nbytes

    def scaled_rows(self, h_local):
        """Every band's rows at the scale where this band has h_local rows."""
        own = self.rows[self.index]
        sizes = [r * h_local // own for r in self.rows]
        if any(r * h_local % own for r in self.rows):
            raise ValueError(f"band: {h_local} rows do not scale the bands {self.rows}")
        return sizes


def _active():
    return getattr(_state, "ctx", None)


def active() -> bool:
    return _active() is not None


@contextlib.contextmanager
def sharded(mesh, rows):
    """Run the enclosed forward as this rank's band: `rows` are every band's
    row counts at full resolution (`mesh.band_rows(H, n_band)`). A mesh of
    one band needs no context."""
    if mesh.n_band < 2:
        raise ValueError("band.sharded: the mesh has one band; run without the context")
    prev = _active()
    _state.ctx = ctx = _Band(mesh, rows)
    try:
        yield ctx
    finally:
        _state.ctx = prev
        # the context's own counters: a backward run later adds to them
        _state.last = {"counts": ctx.counts, "bytes": ctx.bytes}


def reset_counts():
    """Zero `last_counts()` (a forward with no band context leaves it as the
    last context's)."""
    _state.last = {"counts": dict.fromkeys(KINDS, 0), "bytes": dict.fromkeys(KINDS, 0)}


def last_counts():
    """{"counts": {kind: n}, "bytes": {kind: bytes this rank sent}} of the
    last `sharded` context on this thread, with its backward once that has
    run (zeros before the first)."""
    last = getattr(_state, "last", None)
    if last is None:
        return {"counts": dict.fromkeys(KINDS, 0), "bytes": dict.fromkeys(KINDS, 0)}
    return {"counts": dict(last["counts"]), "bytes": dict(last["bytes"])}


def _exchange(ctx, x, send_up, send_down, recv_up, recv_down):
    """One batched send/recv over the band group: `send_up` (rows for the
    band above, or None) and `send_down` (for the band below); receives
    `recv_up` rows from the band above and `recv_down` from the band below
    (0 for none), shaped like x's rows, in x's dtype. Counts one halo
    collective. Returns (rows from above, rows from below), on x's device
    (None where nothing was received)."""
    m, j = ctx.mesh, ctx.index
    ranks = m.band_ranks
    ops, sent = [], 0
    shape = lambda k: (*x.shape[:-2], k, x.shape[-1])  # noqa: E731
    for t, peer in ((send_down, j + 1), (send_up, j - 1)):
        if t is not None:
            t = m.wire(t)
            ops.append(dist.P2POp(dist.isend, t, ranks[peer], group=m.band_group))
            sent += t.numel() * t.element_size()
    above = below = None
    if recv_up:
        above = torch.empty(shape(recv_up), dtype=x.dtype, device=m.comm_device)
        ops.append(dist.P2POp(dist.irecv, above, ranks[j - 1], group=m.band_group))
    if recv_down:
        below = torch.empty(shape(recv_down), dtype=x.dtype, device=m.comm_device)
        ops.append(dist.P2POp(dist.irecv, below, ranks[j + 1], group=m.band_group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    ctx.count("halo", sent)
    return (None if above is None else m.unwire(above),
            None if below is None else m.unwire(below))


class _Halo(torch.autograd.Function):
    """halo's exchange; its backward sends the gradient of the received rows
    back to their senders, who add it into their edge rows."""

    @staticmethod
    def forward(fctx, x, top, bottom, fill, ctx):
        fctx.top, fctx.bottom, fctx.fill, fctx.band = top, bottom, fill, ctx
        j, n = ctx.index, ctx.n
        h = x.shape[-2]
        # my last `top` rows are the top halo of the band below me; my first
        # `bottom` rows the bottom halo of the band above
        above, below = _exchange(
            ctx, x, x[..., :bottom, :] if j > 0 and bottom else None,
            x[..., h - top:, :] if j + 1 < n and top else None,
            top if j > 0 else 0, bottom if j + 1 < n else 0)

        def edge(rows, k):
            shape = (*x.shape[:-2], k, x.shape[-1])
            return x.new_zeros(shape) if fill == "zeros" else rows.expand(shape)

        parts = []
        if top:
            parts.append(above if above is not None else edge(x[..., :1, :], top))
        parts.append(x)
        if bottom:
            parts.append(below if below is not None else edge(x[..., -1:, :], bottom))
        return torch.cat(parts, dim=-2)

    @staticmethod
    def backward(fctx, g):
        top, bottom, fill, ctx = fctx.top, fctx.bottom, fctx.fill, fctx.band
        j, n = ctx.index, ctx.n
        h = g.shape[-2] - top - bottom
        gx = g[..., top:top + h, :].clone()
        g_top, g_bot = g[..., :top, :], g[..., top + h:, :]
        # the gradient of my top halo goes back up to the band that sent it,
        # that of my bottom halo down; I receive those of my edge rows
        from_above, from_below = _exchange(
            ctx, g, g_top if j > 0 and top else None,
            g_bot if j + 1 < n and bottom else None,
            bottom if j > 0 else 0, top if j + 1 < n else 0)
        if from_below is not None:   # my last `top` rows were the halo below
            gx[..., h - top:, :] += from_below
        if from_above is not None:   # my first `bottom` rows the halo above
            gx[..., :bottom, :] += from_above
        if fill == "edge":           # the replicated edge rows sum into the edge
            if j == 0 and top:
                gx[..., :1, :] += g_top.sum(dim=-2, keepdim=True)
            if j + 1 == n and bottom:
                gx[..., -1:, :] += g_bot.sum(dim=-2, keepdim=True)
        return gx, None, None, None, None


def halo(x, top, bottom, fill="zeros"):
    """x (..., h, W) extended to (..., top + h + bottom, W) with the
    neighbouring bands' rows; at the image's edges `fill` ("zeros" or
    "edge") supplies them."""
    ctx = _active()
    if top == bottom == 0:
        return x
    if fill not in ("zeros", "edge"):
        raise ValueError(f"band.halo: fill must be 'zeros' or 'edge', got {fill!r}")
    if max(top, bottom) > x.shape[-2]:
        raise ValueError(f"band.halo: {top}/{bottom} halo rows from a band of "
                         f"{x.shape[-2]} rows")
    return _Halo.apply(x, top, bottom, fill, ctx)


def _sum(ctx, t):
    """t's float32 sum over the band group, in a new tensor; counts one
    all-reduce."""
    ctx.count("all_reduce", t.numel() * t.element_size())
    return all_reduce(ctx.mesh, t.float().clone(), ctx.mesh.band_group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx):
        fctx.band = ctx
        return _sum(ctx, t)

    @staticmethod
    def backward(fctx, g):
        return _sum(fctx.band, g), None


def all_reduce_sum(t):
    """The float32 sum of t over the band group, on t's device."""
    ctx = _active()
    if t.dtype != torch.float32:
        raise ValueError(f"band.all_reduce_sum takes float32, got {t.dtype}")
    return _AllReduceSum.apply(t, ctx)


class _AllGatherRows(torch.autograd.Function):
    """The gather; its backward keeps, of the full map's gradient summed
    over the band group (an all-reduce in float32, counted as one), this
    band's rows."""

    @staticmethod
    def forward(fctx, x, ctx):
        m = ctx.mesh
        sizes = ctx.scaled_rows(x.shape[-2])
        fctx.band, fctx.sizes = ctx, sizes
        ctx.count("all_gather", x[..., :1, :].numel() * max(sizes) * x.element_size())
        return gather_dim(m, x, -2, m.band_group, m.band_ranks, sizes)

    @staticmethod
    def backward(fctx, g):
        ctx, sizes = fctx.band, fctx.sizes
        total = g.float().contiguous().clone()
        ctx.count("all_reduce", total.numel() * total.element_size())
        total = all_reduce(ctx.mesh, total, ctx.mesh.band_group)
        r0 = sum(sizes[:ctx.index])
        return total[..., r0:r0 + sizes[ctx.index], :].to(g.dtype).contiguous(), None


def all_gather_rows(x):
    """The full map (..., H, W) on every rank of the band group from each
    band's (..., h_j, W) rows (bands of unequal size padded to the largest
    for the transfer)."""
    return _AllGatherRows.apply(x, _active())


def rows_of(full, h_local):
    """This band's h_local rows of a full map gathered by `all_gather_rows`."""
    ctx = _active()
    sizes = ctx.scaled_rows(h_local)
    r0 = sum(sizes[:ctx.index])
    return full[..., r0:r0 + h_local, :].contiguous()


def expected_counts(cfg, backward=False):
    """Collectives of one band-sharded forward of `cfg`, per rank, worked out
    from the model's structure (a rank at the image's edge counts its halo
    calls too, though it has one neighbour):

    - halo, one per conv with more than one row of taps and per bilinear x2
      or 3x3 unfold: the stem 5 (5x5/2, 3x3, two 3x3 of conv2, 3x3/2); a
      UNet 15 (six ConvBlock2Ds with two 3x3 convs each, three bilinear
      ups); an MRT 3 (its ups); the global refiner 17 (its UNet, a 3x3 in
      and a 3x3 out); the feature fusion at 1/4 2 (two 3x3 heads); a local
      refiner step 26 (its UNet; the disp features 2, the conf/occ
      features 1, the concat's second conv 1, the two update heads 2 each,
      the ConvGRU's three (3, 1) convs); the 4x mask 2, the
      4x unfold 1, the 1x mask 3 (two 3x3 ConvTs, one 3x3); the 1x filter
      1 unfold, or with output_upsample 3 x (unfold + bilinear);
    - all_gather, one per run of global-attention blocks: the pyramid UNet,
      each MRT, the global refiner's UNet, each local refiner step's UNet;
    - all_reduce, two per GroupNorm (the stem's): the sums and counts, then
      the squared deviations.

    With backward=True, the counts of a training step's forward and
    backward together (the model's parameters taking gradients): each
    halo's and all-reduce's backward is one more collective of its kind,
    except the halo of the 1x mask's RGB ConvT, whose input, the image,
    takes no gradient; each gather's backward is an all-reduce."""
    ntr, r = cfg.num_transformer, cfg.refine_iter
    halo_n = 5 + 15 + 3 * ntr + 17 + 2 + 26 * r + 2 + 1 + 3 + (6 if cfg.output_upsample
                                                              else 1)
    counts = {"halo": halo_n, "all_reduce": 2, "all_gather": 2 + ntr + r}
    if backward:
        counts = {"halo": 2 * halo_n - 1, "all_reduce": 4 + counts["all_gather"],
                  "all_gather": counts["all_gather"]}
    return counts
