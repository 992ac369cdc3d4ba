"""Load a .pt2 artifact and time it, the analog of the reference's
raw-binding TensorRT benchmark (reference: demo/trt_inference_test.py; the
JAX package's demo/artifact_benchmark.py).

    python -m s2m2_torch.demo.artifact_benchmark ARTIFACT [--iters 20]
        [--device cuda]

Only the artifact is loaded (no model source): the resolution comes from
its file name (`s2m2_CH{c}NTR{n}_{W}x{H}_{precision}.pt2`), the images are
uniform random. An artifact that takes its weights as an argument (weight-
free or int8) is given seeded random tensors of the shapes and dtypes its
program declares, which time the same kernels. On the card `--iters` calls
after one warm-up are timed by CUDA events; on the CPU by the host clock.
Prints ms/frame and FPS.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
import time


def _arguments(program, height, width, device, seed=0):
    """Seeded inputs of the shapes and dtypes `program` declares: the two
    images uniform in [0, 255) (raises unless they are height x width),
    int8 inputs uniform in [-127, 127], other float inputs normal x 0.02."""
    import torch
    from torch.utils import _pytree as pytree
    g = torch.Generator(device=device).manual_seed(seed)
    names = set(program.graph_signature.user_inputs)
    specs = [n.meta["val"] for n in program.graph.nodes
             if n.op == "placeholder" and n.name in names]
    leaves = []
    for i, spec in enumerate(specs):
        if i >= len(specs) - 2:
            if tuple(spec.shape[1:3]) != (height, width):
                raise ValueError(f"the file name says {width}x{height}; the program takes "
                                 f"images of shape {tuple(spec.shape)}")
            t = torch.rand(spec.shape, generator=g, device=device) * 255
        elif spec.dtype == torch.int8:
            t = torch.randint(-127, 128, spec.shape, generator=g, device=device,
                              dtype=torch.int8)
        else:
            t = torch.randn(spec.shape, generator=g, device=device) * 0.02
        leaves.append(t.to(spec.dtype))
    args, _ = pytree.tree_unflatten(leaves, program.call_spec.in_spec)
    return args


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("artifact", help="path to a .pt2 artifact")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch
    from ..tools.export import load_artifact

    name = os.path.basename(args.artifact)
    m = re.search(r"_(\d+)x(\d+)_", name)
    if not m:
        print(f"cannot infer the resolution from the file name {name}")
        return 1
    width, height = int(m.group(1)), int(m.group(2))
    fn = load_artifact(args.artifact, device=args.device)
    inputs = _arguments(fn.program, height, width, args.device)
    fn(*inputs)
    if args.device == "cpu":
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn(*inputs)
        dt = (time.perf_counter() - t0) / args.iters
    else:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn(*inputs)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / args.iters
    print(f"{name}: {dt * 1e3:.1f} ms/frame ({1 / dt:.1f} FPS)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
