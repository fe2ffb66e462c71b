"""The control of the check, which has to come out as not correct: the
plain reference computed one precision step below the configuration's
float32, put in the program's place. Its traces run in bfloat16 (rows,
rays and the Baldwin-Weber test: the step that would tempt a later change
to halve the bytes the intersector reads), and its finalize reads the film,
the history and the depth probe rounded to bfloat16.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--seconds <s>]

runs the cell as the benchmark does (set-up, a window of `run_seconds`
unless given, at the cell's own load and size, so it compares as many
frames as a run does), then judges the control's films at the checked pixels
and its finalize of every frame (its own history, from an empty one)
against the float32 reference, and prints one JSON line per seed with the
numbers beside their limits, and the program's own numbers of the same run
under "program". The benchmark's own runs do not run it."""

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from hbench import spec  # noqa: E402
from hbench.runner import process_start, run_cell  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description="the benchmark's control readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window in seconds (default: run_seconds)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no result: the control runs at the cell's own size on a CUDA device",
              file=sys.stderr)
        return 3
    bench = spec.load_benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[args.workload]
    workload = spec.load_named("workloads", args.workload)
    config = spec.load_named("configs", entry["config"])
    seconds = bench["run_seconds"] if args.seconds is None else args.seconds
    for seed in args.seeds:
        result, _ = run_cell(bench, entry, workload, config, seed, seconds, False, "cuda",
                             process_start(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"], "checks": result["checks"],
                          "frames_checked": result["frames_checked"],
                          "program": result["program"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
