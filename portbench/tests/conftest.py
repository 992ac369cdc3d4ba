"""A tiny cell of the benchmark for CPU tests: its own BENCHMARK.json,
configuration, traffic and limits files in a temporary checkout root, and
the real metric readers and architectures copied beside them."""
import json
import shutil
from pathlib import Path

import pytest
import torch

PORTBENCH = Path(__file__).resolve().parents[1]
TINY_MODEL = {"feature_channels": 32, "num_transformer": 1, "dim_expansion": 1, "num_heads": 1,
              "use_positivity": True, "output_upsample": False, "refine_iter": 2, "ot_iter": 3,
              "radius": 4, "pe_dim": 32}
TINY_TRAFFIC = {"height": 64, "width": 96, "batch": 1, "pool": 4, "max_disp": 16, "noise": 2.0,
                "warmup_calls": 1, "trace_after": 1, "trace_calls": 2, "compare_calls": 2}


def write_root(root: Path, limits: dict, batch: int = 1, model=None, traffic=None):
    """A checkout root holding one tiny cell, "tiny.stream" (or a batch of
    `batch` pairs a call), with every metric of the real benchmark; `model`
    and `traffic` replace entries of TINY_MODEL and TINY_TRAFFIC."""
    pb = root / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "archs"):
        shutil.copytree(PORTBENCH / sub, pb / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    real = json.loads((PORTBENCH.parent / "BENCHMARK.json").read_text())
    spec = {"configs": [{"name": "tiny", "file": "portbench/configs/tiny.json"}],
            "workloads": [{"name": "tiny.stream", "config": "tiny", "traffic": "stream",
                           "chips": 1}],
            "end_to_end": [{k: v for k, v in m.items() if k != "workloads"}
                           for m in real["end_to_end"]],
            "per_layer": [{k: v for k, v in m.items() if k != "workloads"}
                          for m in real["per_layer"]]}
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (pb / "configs" / "tiny.json").write_text(json.dumps(
        {"architecture": "s2m2", "model": dict(TINY_MODEL, **(model or {})), "precision": "fp32",
         "fused_block": False, "weight_gain": 2 ** 0.5}))
    traffic = dict(TINY_TRAFFIC, batch=batch, pool=4 * batch, **(traffic or {}))
    (pb / "traffic" / "stream.json").write_text(json.dumps(traffic))
    (pb / "limits" / "tiny.stream.json").write_text(json.dumps(limits))
    return root


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
