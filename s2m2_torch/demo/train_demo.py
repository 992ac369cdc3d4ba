"""Training demo (the reference ships no training; the JAX package's
demo/train_demo.py): fit S2M2 on synthetic stereo scenes or a
Middlebury-style directory, with checkpoints, on one device or
data-parallel over a mesh of local ranks.

    python -m s2m2_torch.demo.train_demo [--model_type S] [--data_root DIR]
        [--steps 50] [--batch 2] [--height 128] [--width 160] [--lr 1e-4]
        [--checkpoint_dir DIR] [--device cuda] [--mesh DxB] [--backend gloo]

The default model is the tiny debug configuration (CH32, NTR1,
refine_iter 1). It trains on the card unless `--device cpu` is given.
`--mesh DxB` starts D*B ranks on this host (`parallel/launch.py`), each
taking its shard of every batch: its slice of the pairs and, with B > 1,
its band of rows (whole 32-row blocks, so the crop's height must split
into them, or the demo refuses it): gloo on the CPU; on the card NCCL with
a card per rank, or `--backend gloo` (the host transport) when the ranks
share fewer cards, e.g. `--mesh 1x2 --backend gloo` on one card.
"""
from __future__ import annotations

import argparse
import os
import sys


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_type", default=None,
                    help="S/M/L/XL; default = tiny debug config")
    ap.add_argument("--data_root", default=None,
                    help="Middlebury-style scene dir; default synthetic")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--mesh", default=None,
                    help="'DATAxBAND', e.g. 2x1 (data parallel) or 1x2 (two bands of rows)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="transport of a mesh on the card (default: NCCL, which "
                         "needs a card per rank)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    return ap


def _mesh_shape(spec, height):
    """(n_data, n_band) of a DATAxBAND spec; raises ValueError on a bad spec,
    or on a crop height that does not split into whole 32-row blocks per
    band."""
    try:
        n_data, n_band = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DATAxBAND, e.g. 2x1, not {spec!r}") from None
    if n_data < 1 or n_band < 1:
        raise ValueError(f"--mesh {spec}: both sizes must be at least 1")
    if n_band > 1:
        from ..parallel.mesh import band_rows
        try:
            band_rows(height, n_band)
        except ValueError as exc:
            raise ValueError(f"--mesh {spec} with --height {height}: {exc}") from None
    return n_data, n_band


def _spawn(argv, n_ranks):
    """Run this demo on n_ranks local ranks; rank 0's output is printed."""
    from ..parallel.launch import RanksFailed, run_ranks
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ,
           "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    try:
        outs = run_ranks(lambda rank, init: [sys.executable, "-m", "s2m2_torch.demo.train_demo",
                                             *argv, "--rank", str(rank), "--init", init],
                         n_ranks, timeout=3600, env=env)
    except RanksFailed as exc:
        print(f"train_demo: {exc}", file=sys.stderr)
        return 1
    print(outs[0], end="")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    mesh = None
    if args.mesh:
        try:
            n_data, n_band = _mesh_shape(args.mesh, args.height)
        except ValueError as exc:
            print(f"train_demo: {exc}", file=sys.stderr)
            return 2
        if args.rank is None:
            return _spawn(argv, n_data * n_band)
        from ..parallel.distributed import initialize_distributed
        from ..parallel.mesh import make_mesh
        initialize_distributed(args.init, n_data * n_band, args.rank)
        mesh = make_mesh(n_data, n_band, device=args.device, backend=args.backend)

    from ..config import ModelConfig, get_config
    from ..train.data import directory_batches, synthetic_stereo_batches
    from ..train.trainer import train

    cfg = (get_config(args.model_type) if args.model_type
           else ModelConfig(feature_channels=32, num_transformer=1, refine_iter=1))
    if args.data_root:
        batches = directory_batches(args.data_root, batch=args.batch,
                                    crop=(args.height, args.width))
    else:
        batches = synthetic_stereo_batches(batch=args.batch, height=args.height,
                                           width=args.width)
    train(cfg, batches, num_steps=args.steps, lr=args.lr,
          checkpoint_dir=args.checkpoint_dir,
          device=None if mesh is not None else args.device, mesh=mesh)
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
