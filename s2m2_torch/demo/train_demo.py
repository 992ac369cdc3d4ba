"""Training demo (the reference ships no training; the JAX package's
demo/train_demo.py): fit S2M2 on synthetic stereo scenes or a
Middlebury-style directory, with checkpoints, on one device.

    python -m s2m2_torch.demo.train_demo [--model_type S] [--data_root DIR]
        [--steps 50] [--batch 2] [--height 128] [--width 160] [--lr 1e-4]
        [--checkpoint_dir DIR] [--device cuda]

The default model is the tiny debug configuration (CH32, NTR1,
refine_iter 1). It trains on the card unless `--device cpu` is given.
`--mesh` (multi-device training) is refused: the port has no multi-device
path yet.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
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
                    help="'DATAxBAND' multi-device training: not ported yet")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh:
        print(f"train_demo: --mesh {args.mesh}: multi-device training is not ported "
              "to s2m2_torch yet; run without --mesh to train on one device",
              file=sys.stderr)
        return 2

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
          checkpoint_dir=args.checkpoint_dir, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
