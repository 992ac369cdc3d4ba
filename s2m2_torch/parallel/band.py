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
one-device code, so no collective and no cost reach that path. Each call
counts one collective of its kind, and the bytes this rank sends;
`last_counts()` holds the counts of the last context on this thread.
`expected_counts` works the counts of one forward out from the config.
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
        _state.last = {"counts": dict(ctx.counts), "bytes": dict(ctx.bytes)}


def reset_counts():
    """Zero `last_counts()` (a forward with no band context leaves it as the
    last context's)."""
    _state.last = {"counts": dict.fromkeys(KINDS, 0), "bytes": dict.fromkeys(KINDS, 0)}


def last_counts():
    """{"counts": {kind: n}, "bytes": {kind: bytes this rank sent}} of the
    last `sharded` context on this thread (zeros before the first)."""
    return getattr(_state, "last", {"counts": dict.fromkeys(KINDS, 0),
                                    "bytes": dict.fromkeys(KINDS, 0)})


def halo(x, top, bottom, fill="zeros"):
    """x (..., h, W) extended to (..., top + h + bottom, W) with the
    neighbouring bands' rows; at the image's edges `fill` ("zeros" or
    "edge") supplies them."""
    ctx = _active()
    if top == bottom == 0:
        return x
    if fill not in ("zeros", "edge"):
        raise ValueError(f"band.halo: fill must be 'zeros' or 'edge', got {fill!r}")
    h = x.shape[-2]
    if max(top, bottom) > h:
        raise ValueError(f"band.halo: {top}/{bottom} halo rows from a band of {h} rows")
    m, j, n = ctx.mesh, ctx.index, ctx.n
    ranks = m.band_ranks
    ops, sent = [], 0
    above = below = None
    shape = lambda k: (*x.shape[:-2], k, x.shape[-1])  # noqa: E731
    # my last `top` rows are the top halo of the band below me; my first
    # `bottom` rows the bottom halo of the band above
    if j + 1 < n and top:
        t = m.wire(x[..., h - top:, :])
        ops.append(dist.P2POp(dist.isend, t, ranks[j + 1], group=m.band_group))
        sent += t.numel() * t.element_size()
    if j > 0 and bottom:
        t = m.wire(x[..., :bottom, :])
        ops.append(dist.P2POp(dist.isend, t, ranks[j - 1], group=m.band_group))
        sent += t.numel() * t.element_size()
    if j > 0 and top:
        above = torch.empty(shape(top), dtype=x.dtype, device=m.comm_device)
        ops.append(dist.P2POp(dist.irecv, above, ranks[j - 1], group=m.band_group))
    if j + 1 < n and bottom:
        below = torch.empty(shape(bottom), dtype=x.dtype, device=m.comm_device)
        ops.append(dist.P2POp(dist.irecv, below, ranks[j + 1], group=m.band_group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    ctx.count("halo", sent)

    def edge(rows, k):
        if fill == "zeros":
            return x.new_zeros(shape(k))
        return rows.expand(shape(k))

    parts = []
    if top:
        parts.append(m.unwire(above) if above is not None else edge(x[..., :1, :], top))
    parts.append(x)
    if bottom:
        parts.append(m.unwire(below) if below is not None else edge(x[..., -1:, :], bottom))
    return torch.cat(parts, dim=-2)


def all_reduce_sum(t):
    """The float32 sum of t over the band group, on t's device."""
    ctx = _active()
    if t.dtype != torch.float32:
        raise ValueError(f"band.all_reduce_sum takes float32, got {t.dtype}")
    ctx.count("all_reduce", t.numel() * t.element_size())
    return all_reduce(ctx.mesh, t, ctx.mesh.band_group)


def all_gather_rows(x):
    """The full map (..., H, W) on every rank of the band group from each
    band's (..., h_j, W) rows (bands of unequal size padded to the largest
    for the transfer)."""
    ctx = _active()
    m = ctx.mesh
    sizes = ctx.scaled_rows(x.shape[-2])
    ctx.count("all_gather", x[..., :1, :].numel() * max(sizes) * x.element_size())
    return gather_dim(m, x, -2, m.band_group, m.band_ranks, sizes)


def rows_of(full, h_local):
    """This band's h_local rows of a full map gathered by `all_gather_rows`."""
    ctx = _active()
    sizes = ctx.scaled_rows(h_local)
    r0 = sum(sizes[:ctx.index])
    return full[..., r0:r0 + h_local, :].contiguous()


def expected_counts(cfg):
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
      the squared deviations."""
    ntr, r = cfg.num_transformer, cfg.refine_iter
    halo_n = 5 + 15 + 3 * ntr + 17 + 2 + 26 * r + 2 + 1 + 3 + (6 if cfg.output_upsample
                                                              else 1)
    return {"halo": halo_n, "all_reduce": 2, "all_gather": 2 + ntr + r}
