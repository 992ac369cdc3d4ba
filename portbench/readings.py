"""The readings a cell's correctness limits are set from.

    python3 portbench/readings.py --workload S_fp32.stream_1216 \
        --seeds 11,12,13,14,15,16,17,18,19,20,21,22 --control-seeds 31,32,33 \
        --controls ref_tf32,disp_plus1,refiner_unchanged

In one process, at the cell's own sizes and load: for each seed of
`--seeds` the program as the cell runs it, and for each of
`--control-seeds` each kind of `--controls`: "ref_tf32", the reference in
the program's place with each conv and linear on TF32 operands, the
precision below the configuration's float32 with TF32 off; a precision of
the program's own ("bf16", "int8"); or a fault of `faults.py` planted in
the program. Each runs a short window whose sampled calls are held against
the float32 reference exactly as a run of the benchmark holds them. Prints
one JSON line per seed, then for each kind the lower reading (the
program's largest), the upper one (the kind's smallest) and their ratio
for every number `compare` computes. The benchmark's own runs never run
this.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


class ReferenceInPlace:
    """The reference behind `StereoEngine.run`'s interface, each conv and
    linear on TF32 operands: the precision below the float32 with TF32 off
    that the configurations state (the program has no TF32 path)."""

    def __init__(self, cell, seed, device):
        from portbench import harness
        from portbench.reference import model as ref_model
        self.device = device
        self.model = harness.reference_model(cell, seed, device)
        for m in self.model.modules():
            if isinstance(m, ref_model._Gemm):
                m.tf32 = True

    def run(self, left, right):
        from portbench.reference import engine as ref_engine
        t = time.perf_counter()
        squeeze = left.ndim == 3
        if squeeze:
            left, right = left[None], right[None]
        disp, occ, conf, score, _ = ref_engine.run(self.model, left, right, self.device)
        if squeeze:
            disp, occ, conf = disp[0], occ[0], conf[0]
        return disp, occ, conf, score, (time.perf_counter() - t) * 1e3


def readings(cell, seed, seconds, device, control=None):
    """The worst of each number over one short window's sampled calls of
    the program (control None) or of a control."""
    import torch
    from portbench import faults, harness
    pool = harness.make_pool(cell, seed, device)
    fault = control if control in faults.FAULTS else None
    if control == "ref_tf32":
        engine = ReferenceInPlace(cell, seed, device)
    else:
        engine = harness.build_engine(cell, device, None if fault else control)
        harness.set_weights(engine, harness.cell_weights(cell, seed, device))
    with faults.plant(fault) if fault else contextlib.nullcontext():
        for i in range(cell.traffic["warmup_calls"]):
            engine.run(*harness.call_inputs(cell, pool, i)[1:])
        _, _, sample, insane, _ = harness.drive(engine, cell, pool, seconds, seed, False,
                                                device)
    del engine
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    model = harness.reference_model(cell, seed, device)
    worst, _ = harness.judge(cell, sample, pool, model, device)
    return dict(worst, insane_pairs=insane)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--controls", default="ref_tf32",
                   help="comma-separated: ref_tf32, bf16, int8, or a fault of faults.py")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from portbench import harness
    cell = harness.load_cell(args.workload, False)
    controls = [c for c in args.controls.split(",") if c]
    runs = {kind: [] for kind in ["program", *controls]}
    for kind, seeds in (("program", args.seeds), *((c, args.control_seeds) for c in controls)):
        for seed in seeds:
            nums = readings(cell, seed, args.seconds, args.device,
                            None if kind == "program" else kind)
            runs[kind].append(nums)
            print(json.dumps({"kind": kind, "seed": seed, **nums}), flush=True)
    for kind in controls if runs["program"] else []:
        summary = {}
        for k in runs["program"][0]:
            lower = max(r[k] for r in runs["program"])
            upper = min(r[k] for r in runs[kind])
            summary[k] = {"lower": lower, "upper": upper,
                          "ratio": upper / lower if lower > 0 else None}
        print(json.dumps({"workload": args.workload, "control": kind, "summary": summary}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
