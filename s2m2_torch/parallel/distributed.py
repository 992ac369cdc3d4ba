"""Multi-process initialisation and the global mesh, the port of
`s2m2_tpu/parallel/distributed.py`.

`initialize_distributed` wires the ranks into one `torch.distributed`
process group; `global_mesh` lays 'data' across hosts and 'band' within a
host (ranks host-major), so band sharding's halo exchanges stay on a host's
links. On one process both degrade: no process group, a 1x1 mesh.

Start ranks with `torchrun --nproc-per-node N script.py` (it sets the
address, world size and rank, which `initialize_distributed(...)` then
takes from its arguments or the environment), with
`parallel/launch.run_ranks`, or with the train demo's `--mesh DxB`.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import DEFAULT_TIMEOUT, all_reduce, host_names, make_mesh


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None, timeout=DEFAULT_TIMEOUT):
    """Join this process to the process group. Returns False and does
    nothing for a single process with no coordinator; otherwise initialises
    once (True) with a `tcp://` init method and a finite `timeout` (seconds).

    coordinator_address: "host:port" or "tcp://host:port" (default:
    MASTER_ADDR:MASTER_PORT, as torchrun sets them); num_processes /
    process_id default to WORLD_SIZE / RANK. backend: "gloo" (the default)
    or "nccl"; under "nccl" the default group still carries host objects
    over gloo ("cpu:gloo,cuda:nccl")."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if num_processes in (None, 1) and coordinator_address is None:
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_distributed: give the coordinator address, the "
                         "number of processes and this process's id")
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"initialize_distributed: backend {backend!r}")
    addr = coordinator_address
    if not addr.startswith("tcp://"):
        addr = f"tcp://{addr}"
    dist.init_process_group("cpu:gloo,cuda:nccl" if backend == "nccl" else "gloo",
                            init_method=addr, world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout))
    return True


def global_mesh(n_data=None, n_band=None, *, device=None, backend=None,
                timeout=DEFAULT_TIMEOUT):
    """Mesh over every rank of every host: 'data' defaults to the number of
    hosts and 'band' to the ranks per host, ranks host-major. Raises on a
    shape that does not cover the world, or when a host's ranks are not
    consecutive."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    hosts = host_names() if dist.is_initialized() else ["localhost"]
    order = list(dict.fromkeys(hosts))
    if hosts != sorted(hosts, key=order.index):
        raise ValueError(f"global_mesh: ranks are not host-major: {hosts}")
    if n_data is None:
        n_data = len(order)
    if n_band is None:
        n_band = world // n_data
    if n_data * n_band != world:
        raise ValueError(f"mesh {n_data}x{n_band} != {world} ranks")
    return make_mesh(n_data, n_band, device=device, backend=backend, timeout=timeout)


def scaling_report(per_chip_fps, n_chips, base_fps=None):
    """Scaling bookkeeping for the 1-card / 1-host / N-host ladder."""
    total = per_chip_fps * n_chips
    out = {"n_chips": n_chips, "fps_per_chip": per_chip_fps, "fps_total": total}
    if base_fps:
        out["scaling_efficiency"] = per_chip_fps / base_fps
    return out


def max_over_ranks(mesh, value):
    """The largest `value` (a float) over the mesh's ranks (an all-reduce of
    the max), e.g. the slowest rank's time; `value` itself on one rank."""
    t = torch.tensor([float(value)], dtype=torch.float64)
    return float(all_reduce(mesh, t, mesh.world_group, dist.ReduceOp.MAX))
