"""Run one cell of the benchmark of s2m2_torch once and print its result.

    python3 portbench/run.py --workload S_fp32.stream_1216 --seed 7 --seconds 30 --trace 0

From the root of a checkout of the repository, on a machine with an NVIDIA
card. Set-up (weights and inputs from the seed, the engine, two warm
calls, and on a checkout's first run the nvcc build of the kernels into
build/) comes first; then calls of `StereoEngine.run` for `--seconds`
seconds; then the check of the window's outputs against the plain
reference. The last line of standard output is one JSON object: with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics from a profiled slice of the window. The numbers compared with the
reference and their limits are the last lines of standard error. With no
card, or fewer cards than the cell asks for, it exits with code 3 and
prints no result.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# caches of the program's kernels and of any library that builds them, at
# fixed paths inside the checkout, so that only a checkout's first run builds
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None):
    import argparse
    import json
    import subprocess

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from portbench import harness
    try:
        import s2m2_torch  # noqa: F401
    except ImportError as err:
        print(f"portbench: the program s2m2_torch is not importable from {ROOT}: {err}",
              file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    result = harness.run_cell(cell, args.seed % 2**64, args.seconds, bool(args.trace),
                              device="cuda", log=lambda line: print(line, flush=True))
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}, which the benchmark forbids", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
