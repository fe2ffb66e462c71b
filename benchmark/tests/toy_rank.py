"""One rank of a toy run of a cell on the CPU, in a process of its own (rank
0 of a multi-chip cell ends its process when a follower fails, which must
not end the test's). The look for a chip is skipped: the cell runs on the
CPU at the tests' toy size, in a gloo group of `--chips` processes, with
an optional fault planted (faults.py) on every rank.

    python benchmark/tests/toy_rank.py lead --workload <cell> --chips 2 --seed <n> \\
        --seconds <s> [--trace] [--control] [--fault <name>]

prints what `benchmark/run.py` prints and exits with its code; rank 0
starts each follower as `toy_rank.py follow --fault <name> -- <follower
arguments>`."""

import argparse
import os
import sys
import time

_TESTS = os.path.dirname(os.path.abspath(__file__))
_BENCH = os.path.dirname(_TESTS)
sys.path[:0] = [_TESTS, _BENCH, os.path.dirname(_BENCH)]

import faults  # noqa: E402
from hbench import group, runner, spec  # noqa: E402

TOY = {"Image": {"image_width": 48, "image_height": 27}}
TOY_CHECK_PIXELS = 96
# torch threads per process: the test lane runs several workers at once
THREADS = 2


def toy_cell(bench, cell, chips=None):
    """(entry, workload, config) of `cell` at the toy size, on `chips`
    processes where given."""
    entry = {w["name"]: w for w in bench["workloads"]}[cell]
    if chips is not None:
        entry = dict(entry, chips=chips)
    wl = dict(spec.load_named("workloads", cell), check_pixels_per_frame=TOY_CHECK_PIXELS)
    cfg = spec.merge(spec.load_named("configs", entry["config"]), {"option": TOY})
    return entry, wl, cfg


def lead(args) -> int:
    fault = args.fault
    if fault:
        faults.install(fault, setattr, rank=0)
    command = group.follower_command

    def follower_command(*a):
        return [sys.executable, os.path.abspath(__file__), "follow", "--fault", fault or "",
                "--", *command(*a)[2:]]

    group.follower_command = follower_command
    bench = spec.load_benchmark()
    entry, wl, cfg = toy_cell(bench, args.workload, args.chips)
    try:
        res, rows = runner.run_cell(bench, entry, wl, cfg, args.seed, args.seconds,
                                    args.trace, "cpu", time.monotonic(), control=args.control)
    except group.FollowerError as e:
        print(f"no result: {e}", file=sys.stderr)
        return group.FOLLOWER_FAILED
    return runner.report(res, rows)


def follow(args) -> int:
    if args.fault:
        faults.install(args.fault, setattr, rank=1)
    import follower

    return follower.main(args.rest)


def main(argv):
    import torch

    torch.set_num_threads(THREADS)
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="role", required=True)
    a = sub.add_parser("lead")
    a.add_argument("--workload", required=True)
    a.add_argument("--chips", type=int, default=None)
    a.add_argument("--seed", type=int, required=True)
    a.add_argument("--seconds", type=float, required=True)
    a.add_argument("--trace", action="store_true")
    a.add_argument("--control", action="store_true")
    a.add_argument("--fault", choices=faults.NAMES)
    f = sub.add_parser("follow")
    f.add_argument("--fault", default="")
    f.add_argument("rest", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.role == "follow":
        args.rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
        return follow(args)
    return lead(args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
