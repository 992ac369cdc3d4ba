"""The readings a cell's correctness limits are set from.

    python3 portbench/readings.py --workload S_fp32.stream_1216 \
        --seeds 11,12,13,14,15,16,17,18,19,20,21,22 --control-seeds 31,32,33 \
        --controls ref_tf32,disp_plus1,refiner_unchanged

In one process, at the cell's own sizes and load: for each seed of
`--seeds` the program as the cell runs it, and for each of
`--control-seeds` each kind of `--controls` (by default every control of
the architecture): a control of the cell's architecture's `CONTROLS`, the
reference put in the program's place and computed in the precision below
the configuration's (such as "ref_tf32", each conv and linear on TF32
operands where float32 with TF32 off is stated); a precision of the
program's own ("bf16", "int8"); or a fault of the architecture's `FAULTS`
planted in the program. Each runs a short window whose sampled calls are
held against the float32 reference exactly as a run of the benchmark
holds them. Prints one JSON line per seed, then for each kind the lower
reading (the program's largest), the upper one (the kind's smallest) and
their ratio for every number the architecture's `numbers` computes. The
benchmark's own runs never run this.
"""
import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def control(cell, kind, seed, device):
    """The control `kind` of the cell's architecture's `CONTROLS` in the
    program's place: an object whose `run` the window calls, built on the
    reference with the cell's weights at `seed`."""
    from portbench import harness
    return cell.arch.CONTROLS[kind](harness.reference_model(cell, seed, device), device)


def readings(cell, seed, seconds, device, kind=None):
    """The worst of each number over one short window's sampled calls of
    the program (kind None) or of a control, a precision or a fault."""
    import torch
    from portbench import faults, harness
    pool = harness.make_pool(cell, seed, device)
    fault = kind if kind in cell.arch.FAULTS else None
    if kind in getattr(cell.arch, "CONTROLS", {}):
        engine = control(cell, kind, seed, device)
    else:
        engine = harness.build_engine(cell, device, None if fault else kind)
        harness.set_weights(engine, harness.cell_weights(cell, seed, device))
    with faults.plant(cell, fault) if fault else contextlib.nullcontext():
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
    p.add_argument("--controls", default=None,
                   help="comma-separated: a control of the architecture's CONTROLS, a "
                        "precision of the program (bf16, int8), or a fault of its FAULTS; "
                        "by default every control")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from portbench import harness
    cell = harness.load_cell(args.workload, False)
    controls = ([c for c in args.controls.split(",") if c] if args.controls is not None
                else list(getattr(cell.arch, "CONTROLS", {})))
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
