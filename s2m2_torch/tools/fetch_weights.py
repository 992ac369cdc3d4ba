"""Fetch the released reference checkpoints and convert them, from
`s2m2_tpu/tools/fetch_weights.py`.

The reference publishes its trained weights on HuggingFace (files
CH{ch}NTR{n}.pth). This downloads one variant's `.pth` (unless it is
already there) and converts it to the JAX-layout `.npz` through the port's
`tools/convert.py`, so both packages read it:

  python -m s2m2_torch.tools.fetch_weights --model S --out weights/
  StereoEngine("S", checkpoint="weights/CH128NTR1.npz")   # or the .pth

`--url-base` points at a mirror or a local file:// tree (how the tests run
it: they use no network).
"""
from __future__ import annotations

import argparse
import os
import sys
import urllib.request

import numpy as np

from ..config import VARIANTS

HF_BASE = "https://huggingface.co/minimok/s2m2/resolve/main"


def checkpoint_filename(model_type: str) -> str:
    v = VARIANTS[model_type]
    return f"CH{v['feature_channels']}NTR{v['num_transformer']}.pth"


def convert_pth(pth_path: str, npz_path: str):
    """A reference `.pth` state dict -> a JAX-layout `.npz` of float32 arrays."""
    from .convert import load_checkpoint, to_jax
    np.savez(npz_path, **to_jax(load_checkpoint(pth_path)))


def fetch(model_type: str, out_dir: str, url_base: str = HF_BASE,
          convert: bool = True, progress=print) -> str:
    """Download (if missing) and convert one variant's checkpoint. Returns the
    path of the converted .npz (of the .pth with convert=False)."""
    os.makedirs(out_dir, exist_ok=True)
    fname = checkpoint_filename(model_type)
    pth_path = os.path.join(out_dir, fname)
    if not os.path.exists(pth_path):
        url = f"{url_base}/{fname}"
        progress(f"downloading {url} -> {pth_path}")
        tmp = pth_path + ".part"
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, pth_path)
    else:
        progress(f"found existing {pth_path}")
    if not convert:
        return pth_path
    npz_path = pth_path[:-4] + ".npz"
    if not os.path.exists(npz_path):
        progress(f"converting {pth_path} -> {npz_path}")
        convert_pth(pth_path, npz_path)
    else:
        progress(f"found existing {npz_path}")
    return npz_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="all", choices=["all"] + sorted(VARIANTS))
    ap.add_argument("--out", default="weights")
    ap.add_argument("--url-base", default=HF_BASE,
                    help="override for mirrors / local file:// trees")
    ap.add_argument("--no-convert", action="store_true",
                    help="download only, skip .pth -> .npz conversion")
    args = ap.parse_args(argv)
    models = sorted(VARIANTS) if args.model == "all" else [args.model]
    for m in models:
        path = fetch(m, args.out, url_base=args.url_base, convert=not args.no_convert)
        print(f"{m}: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
