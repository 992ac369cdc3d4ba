"""Device mesh and sharding layout, the port of `s2m2_tpu/parallel/mesh.py`.

Mesh axes ('data', 'band'):

- 'data' splits the pairs of a batch over ranks;
- 'band' splits each pair's rows into epipolar bands of whole 32-row
  blocks. Scanline attention, the OT matcher and the cost volume read one
  row at a time, so a band needs other bands' rows only where a primitive
  reads across rows: conv halos and the 1/32 global-attention bottleneck.

Parameters are replicated. The JAX package annotates these shardings and
GSPMD inserts the collectives; torch has none, so the port places each by
hand (`parallel/band.py`, consulted by the few cross-row primitives).

Ranks: global rank = data * n_band + band, so a band group is a run of
consecutive ranks (one host's, see `distributed.global_mesh`). Every rank
creates every group, in the same order.

Transport. CPU tensors go over gloo. CUDA tensors go over NCCL when each
rank of a host has its own card. With fewer cards than ranks NCCL refuses
(two ranks on one device), so `make_mesh` raises and asks for
`backend="gloo"`, the host transport: gloo on host copies of the tensors,
which `Mesh.wire` / `Mesh.unwire` make explicitly. The mesh never switches
transport on its own.
"""
from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

ROW_BLOCK = 32          # a band is whole blocks of this many rows
DEFAULT_TIMEOUT = 60.0  # seconds a collective may wait before it raises


@dataclass
class Mesh:
    """This rank's place on a ('data', 'band') mesh and the groups it talks
    over. A 1x1 mesh has no groups and needs no process group."""
    n_data: int
    n_band: int
    data: int
    band: int
    device: torch.device
    backend: Optional[str]
    band_group: object = None    # the ranks of this rank's pair (None: 1 band)
    data_group: object = None    # the ranks of this band index (None: 1 data)
    world_group: object = None   # every rank of the mesh (None: 1 rank)
    band_ranks: tuple = (0,)     # global ranks of band_group, in band order
    data_ranks: tuple = (0,)     # global ranks of data_group, in data order

    axis_names = ("data", "band")

    @property
    def shape(self):
        return (self.n_data, self.n_band)

    @property
    def size(self):
        return self.n_data * self.n_band

    @property
    def rank(self):
        return self.data * self.n_band + self.band

    @property
    def host_copy(self) -> bool:
        """Whether collectives move host copies (CUDA tensors over gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def comm_device(self) -> torch.device:
        """Where the tensors of a collective lie: the host under gloo."""
        return torch.device("cpu") if self.backend == "gloo" else self.device

    @property
    def transport(self) -> str:
        if self.size == 1:
            return "none"
        return "gloo, host copies" if self.host_copy else self.backend

    def wire(self, t):
        """t as a collective takes it: contiguous, on `comm_device` (a host
        copy under the host transport)."""
        return t.to(self.comm_device).contiguous()

    def unwire(self, t):
        """A received tensor back on the mesh's device."""
        return t.to(self.device)


def band_rows(h: int, n_band: int):
    """Rows of each band of an h-row image: whole 32-row blocks, as evenly as
    possible, earlier bands first. Raises when there are fewer blocks than
    bands, or when h is not a multiple of 32 (the engine pads to 32, so the
    padded size is the unsharded engine's)."""
    if h % ROW_BLOCK:
        raise ValueError(f"band_rows: height {h} is not a multiple of {ROW_BLOCK}")
    blocks = h // ROW_BLOCK
    if blocks < n_band:
        raise ValueError(f"band_rows: {h} rows are {blocks} blocks of {ROW_BLOCK}, "
                         f"fewer than the {n_band} bands")
    base, extra = divmod(blocks, n_band)
    return [ROW_BLOCK * (base + (j < extra)) for j in range(n_band)]


def _local_layout():
    """(local rank, ranks on this host): torchrun's LOCAL_RANK /
    LOCAL_WORLD_SIZE where set, else from every rank's host name."""
    if "LOCAL_RANK" in os.environ and "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_RANK"]), int(os.environ["LOCAL_WORLD_SIZE"])
    if not dist.is_initialized():
        return 0, 1
    hosts = host_names()
    me = hosts[dist.get_rank()]
    return hosts[:dist.get_rank()].count(me), hosts.count(me)


def host_names():
    """Every rank's host name, in rank order (one all_gather_object)."""
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    return hosts


def resolve_device(device, local_rank=0):
    """torch.device of a rank: "cuda" without an index is the host's card
    local_rank % (cards); a CUDA device without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("mesh: CUDA is not available; pass device='cpu'")
        if device.index is None:
            device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def choose_backend(device, ranks_per_host, backend=None):
    """The transport rule of the module docstring. Raises, never falls back."""
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"mesh: CPU tensors go over gloo, not {backend!r}")
        return "gloo"
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"mesh: backend must be 'nccl' or 'gloo', got {backend!r}")
    cards = torch.cuda.device_count()
    if backend in (None, "nccl") and ranks_per_host > cards:
        raise RuntimeError(
            f"mesh: {ranks_per_host} ranks on this host share {cards} card(s), and NCCL "
            "needs a card per rank; pass backend='gloo' for the host transport (gloo "
            "on host copies of the tensors)")
    return backend or "nccl"


def make_mesh(n_data: int = 1, n_band: Optional[int] = None, *, device=None,
              backend=None, timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """The ('data', 'band') mesh over every rank of the process group
    (`distributed.initialize_distributed`), n_data x n_band of them; n_band
    defaults to the ranks left over by n_data. Without a process group the
    world is one rank, and a 1x1 mesh needs none (as JAX's `make_mesh`
    degrades on one device). Every process group is created with `timeout`
    seconds, after which a collective raises."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_band is None:
        n_band = world // max(n_data, 1)
    if n_data < 1 or n_band < 1 or n_data * n_band != world:
        raise ValueError(f"mesh {n_data}x{n_band} does not cover the {world} rank(s) "
                         "of the process group")
    local_rank, per_host = _local_layout()
    device = resolve_device(device, local_rank)
    if world == 1:
        return Mesh(1, 1, 0, 0, device, None)
    backend = choose_backend(device, per_host, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    td = datetime.timedelta(seconds=timeout)

    def group(ranks):
        # every rank enters new_group for every group, in this order
        return dist.new_group(list(ranks), backend=backend, timeout=td)

    data, band = divmod(rank, n_band)
    band_sets = [tuple(d * n_band + j for j in range(n_band)) for d in range(n_data)]
    data_sets = [tuple(d * n_band + j for d in range(n_data)) for j in range(n_band)]
    band_groups = [group(r) for r in band_sets] if n_band > 1 else [None] * n_data
    data_groups = [group(r) for r in data_sets] if n_data > 1 else [None] * n_band
    world_group = group(range(world))
    return Mesh(n_data, n_band, data, band, device, backend, band_groups[data],
                data_groups[band], world_group, band_sets[data], data_sets[band])


def gather_dim(mesh: Mesh, t, dim, group, ranks, sizes=None):
    """Concatenate every rank's t of `group` along `dim`, in the order of
    `ranks`. The sizes along `dim` may differ: `sizes` gives them, or one
    small all_gather exchanges them first; each part travels padded to the
    largest. The other dims must agree. Returns t itself on a 1-rank group."""
    if group is None:
        return t
    dim = dim % t.dim()
    if sizes is None:
        size = torch.tensor([t.shape[dim]], dtype=torch.int64, device=mesh.comm_device)
        parts = [torch.zeros_like(size) for _ in ranks]
        dist.all_gather(parts, size, group=group)
        sizes = [int(s) for s in parts]
    top = max(sizes)
    w = mesh.wire(t)
    if w.shape[dim] < top:
        w = torch.nn.functional.pad(w, [0, 0] * (t.dim() - dim - 1) + [0, top - w.shape[dim]])
    parts = [torch.empty_like(w) for _ in ranks]
    dist.all_gather(parts, w, group=group)
    return mesh.unwire(torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                                 dim=dim))


def all_reduce(mesh: Mesh, t, group, op=dist.ReduceOp.SUM):
    """t reduced over `group` by `op` (t itself on a 1-rank group), on t's
    device. The reduction may run in t's own storage."""
    if group is None:
        return t
    w = mesh.wire(t)
    dist.all_reduce(w, op=op, group=group)
    return w.to(t.device)


def data_slice(mesh: Mesh, x):
    """This data rank's share of x's leading (batch) axis; raises unless the
    batch splits evenly over the data ranks."""
    b = x.shape[0]
    if b % mesh.n_data:
        raise ValueError(f"batch {b} does not split over {mesh.n_data} data ranks")
    bb = b // mesh.n_data
    return x[mesh.data * bb:(mesh.data + 1) * bb]


class ImageSharding:
    """(B, H, W, C) images: B over 'data', H over 'band' (whole 32-row
    blocks, `band_rows`)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def rows(self, h: int):
        """(first row, rows) of this rank's band of an h-row image."""
        rows = band_rows(h, self.mesh.n_band)
        return sum(rows[:self.mesh.band]), rows[self.mesh.band]

    def shard(self, x):
        """This rank's slice of x (a view where x allows one)."""
        r0, n = self.rows(x.shape[1])
        return data_slice(self.mesh, x)[:, r0:r0 + n]

    def gather(self, y):
        """The full array on every rank from each rank's (B/n_data, rows, ...)
        slice: over 'band' along axis 1, then over 'data' along axis 0."""
        m = self.mesh
        y = gather_dim(m, y, 1, m.band_group, m.band_ranks)
        return gather_dim(m, y, 0, m.data_group, m.data_ranks)


def image_sharding(mesh: Mesh) -> ImageSharding:
    return ImageSharding(mesh)


class Replicated:
    """Makes a module's parameters and buffers equal on every rank of the
    mesh: one broadcast from global rank 0 per dtype, of all of them
    flattened."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    @torch.no_grad()
    def __call__(self, module):
        m = self.mesh
        if m.world_group is None:
            return module
        tensors = [t for t in (*module.parameters(), *module.buffers())]
        for dtype in sorted({t.dtype for t in tensors}, key=str):
            same = [t for t in tensors if t.dtype == dtype]
            flat = m.wire(torch.cat([t.reshape(-1) for t in same]))
            dist.broadcast(flat, src=0, group=m.world_group)
            flat = m.unwire(flat)
            offset = 0
            for t in same:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
        return module


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)
