"""Where one traced frame of a cell goes, by the program's spans:

    python3 benchmark/span_tables.py --workload <cell> --seed <n> --seconds <s> [--out F]

runs the cell as `run.py --trace 1` does and prints one JSON object: the
result line's metrics and correctness, the traced frame's stats, and two
tables, top 10 each: the device's idle seconds by the innermost span open
over them (hbench.spans.idle_by_span) and the host's self seconds by span
(a span's time less its children's). A program that records no spans gives
the stats without the tables."""

import argparse
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from hbench import runner, spec  # noqa: E402
from hbench.spans import idle_by_span, innermost  # noqa: E402


def _top(by: dict, n: int = 10) -> list:
    return [[k if k is not None else "(no span)", v * 1e-9]
            for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def tables(ctx) -> dict:
    """The traced frame's tables from a reader's ctx (empty without spans)."""
    spans = (ctx.get("traced") or [{}])[0].get("spans")
    if not spans:
        return {}
    self_ns, count = {}, {}
    for s, e, name in innermost(spans):
        self_ns[name] = self_ns.get(name, 0) + e - s
    for name, *_ in spans:
        count[name] = count.get(name, 0) + 1
    out = {"n_spans": len(spans), "spans_by_name": count, "self_s_by_span": _top(self_ns)}
    t = ctx.get("trace")
    if t is not None and t.kernels:
        idle = idle_by_span(spans, [(s, e) for _, s, e in t.kernels])
        out.update(idle_total_s=sum(idle.values()) * 1e-9, idle_s_by_span=_top(idle))
    return out


def main(argv=None) -> int:
    t_start = runner.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="also write the object to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no result: the tables need a CUDA device", file=sys.stderr)
        return 3
    bench = spec.load_benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[args.workload]
    seen = {}
    reader = spec.metric_reader

    def keeping(name):
        # every reader is handed the same ctx: keep it for the tables
        mod = reader(name)
        read = mod.read

        def kept(ctx):
            seen["ctx"] = ctx
            return read(ctx)

        mod.read = kept
        return mod

    spec.metric_reader = keeping
    try:
        res, _ = runner.run_cell(bench, entry, spec.load_named("workloads", args.workload),
                                 spec.load_named("configs", entry["config"]), args.seed,
                                 args.seconds, True, "cuda", t_start)
    finally:
        spec.metric_reader = reader
    ctx = seen["ctx"]
    frame = {k: v for k, v in ctx["traced"][0].items() if k != "spans"}
    line = dict(cell=args.workload, seed=args.seed, correct=res["correct"],
                metrics={k: v["value"] for k, v in res["metrics"].items()},
                device=res["device"], traced_frame=frame, window_s=ctx["trace"].window_s,
                **tables(ctx))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
