"""The port's multi-process helpers (s2m2_torch/parallel/distributed.py,
mesh.py, launch.py), the counterparts of tests/test_distributed.py: the
no-op initialisation, the global mesh's shape and a bad shape raising, the
scaling report, a two-process loopback over gloo, the transport rule, and
a launcher that never hangs."""
import sys

import pytest
import torch

from s2m2_torch.parallel import mesh as pmesh
from s2m2_torch.parallel.distributed import (global_mesh, initialize_distributed,
                                             scaling_report)
from s2m2_torch.parallel.launch import RanksFailed, run_ranks

from tests.torch_parallel_ranks import run


def test_initialize_noop_single_process(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed(num_processes=1) is False
    assert not torch.distributed.is_initialized()


def test_global_mesh_one_process():
    mesh = global_mesh(device="cpu")
    assert mesh.axis_names == ("data", "band")
    assert mesh.shape == (1, 1) and mesh.world_group is None
    assert pmesh.make_mesh(device="cpu").shape == (1, 1)   # no process group needed


def test_global_mesh_rejects_bad_shape():
    with pytest.raises(ValueError):
        global_mesh(n_data=3, n_band=4, device="cpu")
    with pytest.raises(ValueError):
        pmesh.make_mesh(2, 1, device="cpu")


def test_scaling_report():
    rep = scaling_report(per_chip_fps=2.5, n_chips=8, base_fps=2.75)
    assert rep["fps_total"] == 20.0
    assert abs(rep["scaling_efficiency"] - 2.5 / 2.75) < 1e-9


def test_two_process_loopback(tmp_path):
    """Two processes over loopback: initialize_distributed wires them,
    global_mesh lays both ranks of this host on 'band', and a collective
    across the processes runs."""
    values, outs = run("loopback", 2, tmp_path, stdout=True)
    for rank, (val, out) in enumerate(zip(values, outs)):
        assert "ALLGATHER [1.0, 2.0]" in out, out
        assert val["shape"] == (1, 2) and val["coords"] == (0, rank)
        assert val["transport"] == "gloo"


def test_transport_rule(monkeypatch):
    """CPU tensors go over gloo; CUDA tensors over NCCL only with a card per
    rank of the host, else the caller must ask for gloo (host copies)."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert pmesh.choose_backend(cpu, 4) == "gloo"
    with pytest.raises(ValueError, match="gloo"):
        pmesh.choose_backend(cpu, 2, "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        pmesh.choose_backend(cuda, 2)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        pmesh.choose_backend(cuda, 2, "nccl")
    assert pmesh.choose_backend(cuda, 2, "gloo") == "gloo"
    assert pmesh.choose_backend(cuda, 1) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pmesh.choose_backend(cuda, 2) == "nccl"
    host = pmesh.Mesh(1, 2, 0, 0, cuda, "gloo")
    assert host.host_copy and host.comm_device == cpu
    assert host.transport == "gloo, host copies"


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_mesh()


def test_launcher_reports_a_failed_rank_and_stops_the_others():
    def argv(rank, init):
        code = ("import sys, time; print('rank', sys.argv[1], sys.argv[2][:6]);"
                "sys.exit(3) if sys.argv[1] == '1' else time.sleep(60)")
        return [sys.executable, "-c", code, str(rank), init]
    with pytest.raises(RanksFailed) as exc:
        run_ranks(argv, 2, timeout=30)
    assert "rank 1: exit 3" in str(exc.value) and "rank 1 tcp://" in str(exc.value)


def test_launcher_times_out():
    with pytest.raises(RanksFailed, match="timed out"):
        run_ranks(lambda r, i: [sys.executable, "-c", "import time; time.sleep(60)"], 2,
                  timeout=1)


def test_halo_exchange_times_out_and_raises(tmp_path):
    """A halo exchange whose neighbour never answers raises once the group's
    timeout (here 3 s) has passed."""
    (kind, message, waited), _ = run("halo_timeout", 2, tmp_path, timeout=60)
    assert kind == "RuntimeError" and "Timed out" in message, message
    assert 2.5 <= waited <= 30, waited
