"""One run of one cell: set-up, the measured window over the program's
frame loop, the metrics, and the check against the plain reference.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the numbers
compared beside their limits); the same numbers are the last lines of
standard error. Without a CUDA device, or with fewer than the cell asks
for, it prints no result and exits 3.

A cell on one chip renders in this process on `cuda`, with no process
group. A cell on n > 1 chips renders as one process per GPU in an NCCL
group, this process being rank 0 on `cuda:0` (hbench/group.py): every
metric and the trace are rank 0's, the memory peak is the fullest GPU's,
and the check judges rank 0's films, which hold the whole group's
samples."""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import shutil
import sys
import tempfile
import time

from hbench import group, spec
from hbench.check import film_numbers, final_numbers, judge
from hbench.hooks import Hooks
from hbench.window import Window, WindowClosed

# modules no process of the benchmark may hold once its window has closed,
# compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "henjou_tpu")


def process_start() -> float:
    """time.monotonic() at which this process started (from /proc), or
    now where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - age
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _parse(argv):
    ap = argparse.ArgumentParser(description="henjou_torch benchmark: one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_start = process_start()
    args = _parse(argv)
    bench = spec.load_benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in entries:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    entry = entries[args.workload]
    workload = spec.load_named("workloads", args.workload)
    config = spec.load_named("configs", entry["config"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"no result: the cell needs {entry['chips']} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        result, rows = run_cell(bench, entry, workload, config, args.seed, args.seconds,
                                bool(args.trace), "cuda", t_start)
    except group.FollowerError as e:
        print(f"no result: {e}", file=sys.stderr)
        return group.FOLLOWER_FAILED
    return report(result, rows)


def report(result: dict, rows: list) -> int:
    """Print a run's result (the exit code 0), or, where this process
    holds a JAX module, no result (4)."""
    found = forbidden_modules()
    if found:
        print(f"no result: the process holds {', '.join(found)}", file=sys.stderr)
        return 4
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def run_cell(bench, entry, workload, config, seed, seconds, trace, device, t_start,
             control=False):
    """(result dict, [(name, value, limit)]) of one run on `device`. With
    `control`, the numbers are the control's (see control.py): the
    reference in bfloat16 put in the program's place; the program's own
    are then under the result's "program" key."""
    import torch

    cell = entry["name"]
    chips = int(entry["chips"])
    cuda = torch.device(device).type == "cuda"
    out_dir = tempfile.mkdtemp(prefix=f"hbench-{cell}-")
    leader = None
    try:
        opt = spec.run_option(config, workload, seed, out_dir)
        opt_path = os.path.join(out_dir, "option.json")
        with open(opt_path, "w") as f:
            json.dump(opt, f)
        width, height = opt["Image"]["image_width"], opt["Image"]["image_height"]
        if opt.get("Render_mode") == "DenoiseUpScale2X":
            width, height = width // 2, height // 2
        spp = int(opt["Image"]["max_spp"])
        engine = opt.get("TPU", {}).get("engine", "auto")
        engine = "wavefront" if engine == "auto" else engine
        pick = functools.lru_cache(maxsize=None)(
            lambda frame: spec.check_pixels(seed, frame, width * height,
                                            int(workload["check_pixels_per_frame"])))
        kind = "per_layer" if trace else "end_to_end"
        wanted = [(m, spec.metric_reader(m["name"])) for m in spec.cell_metrics(bench, cell, kind)]

        if chips > 1:
            # the followers start and the group forms before rank 0 builds
            # its renderer, as the CLI's workers do
            leader = group.Leader(chips, opt_path, torch.device(device).type)
            device = str(leader.device)

        from henjou_torch.runtime.renderer import Renderer

        r = Renderer(device=device)
        hooks = Hooks()
        prof = []
        traced = []  # host seconds the profiler was on, sync to sync

        def trace_start():
            # one install per reader: a metric split by cell counts under its quantity
            for q, mod in {spec.quantity(m["name"]): mod for m, mod in wanted}.items():
                if hasattr(mod, "HOOKS"):
                    hooks.install(q, mod.HOOKS, mod.count, getattr(mod, "COUNTER", None))
            from torch.profiler import ProfilerActivity, profile

            p = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
            if cuda:
                torch.cuda.synchronize(device)
            p.start()
            prof.append(p)
            traced.append(time.monotonic())

        def trace_stop():
            if cuda:
                torch.cuda.synchronize(device)
            traced.append(time.monotonic())
            prof[0].stop()
            hooks.remove()

        win = Window(r, seconds, pick, (trace_start, trace_stop) if trace else None,
                     warmup=int(workload.get("warmup_frames", 1)),
                     lockstep=group.lockstep if leader else None)
        try:
            r.initialize_and_render(opt_path)
        except WindowClosed:
            pass
        else:
            raise RuntimeError("the frame loop ended before the window closed")
        # the peak on the fullest chip: rank 0's, or a follower's
        peak = leader.close() if leader else 0

        if cuda:
            torch.cuda.synchronize(device)
        dev_info = {"platform": "gpu" if cuda else "cpu",
                    "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                    "count": chips,
                    "memory_peak_bytes": max(peak, int(torch.cuda.max_memory_allocated(device)))
                    if cuda else 0}
        stats = r.frame_stats
        frames = win.window_frames(stats)
        ctx = {"width": width, "height": height,
               "memory_peak_bytes": dev_info["memory_peak_bytes"],
               "setup_s": win.t_open - t_start, "setup_stats": dict(r.setup_stats),
               "window": {"t_open": win.t_open, "t_close": win.t_close, "frames": frames}}
        breakdown = None
        if trace:
            from hbench.trace import DeviceTrace

            dt = DeviceTrace.from_profiler(prof[0], traced[1] - traced[0])
            ctx.update(trace=dt, traced=win.traced_frames(stats), hooks=hooks.sums)
            dev_info.update(busy_s=dt.busy_s(), window_s=dt.window_s)
            breakdown = {"device_ops": dt.top_ops(), "idle_gaps": dt.idle_gaps()}
        metrics = {}
        for m, mod in wanted:
            v = mod.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        done = [s for s in stats if win.in_window(s["frame"])]
        failed = sum(1 for s in done if s["spp"] != spp or not s.get("film_finite", True))
        attempted = len(done)

        # the program's outputs for the check; then the rest of its memory
        # goes
        samples, films, images = win.samples, win.films, win.images
        del r, win, prof, ctx, stats
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t_ref = time.monotonic()
        from hbench.reference import reference_films, reference_finals
        from plainref.render import PlainRenderer

        ref = PlainRenderer(opt_path, device)
        ref_films = reference_films(ref, sorted(samples), pick, engine, spp)
        ref_images = reference_finals(ref, films)
        program = None
        if control:
            # the program's own numbers on the same seed, beside the control's
            numbers = film_numbers(samples, ref_films)
            numbers.update(final_numbers(images, ref_images))
            ok, rows = judge(numbers, workload["limits"])
            program = {"correct": bool(ok and failed == 0 and attempted > 0),
                       "checks": {n: {"value": v, "limit": lim} for n, v, lim in rows}}
            low = PlainRenderer(opt_path, device, torch.bfloat16, torch.bfloat16)
            samples = reference_films(low, sorted(samples), pick, engine, spp)
            images = reference_finals(low, films)
        numbers = film_numbers(samples, ref_films)
        numbers.update(final_numbers(images, ref_images))
        ok, rows = judge(numbers, workload["limits"])
        result = {"correct": bool(ok and failed == 0 and attempted > 0),
                  "attempted": attempted, "failed": failed, "metrics": metrics,
                  "device": dev_info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["frames_checked"] = {"film": len(samples), "final": len(ref_images)}
        result["frame_s"] = [[f["frame"], f["render_s"], f["finalize_s"], f["total_s"]]
                             for f in frames]
        result["reference_s"] = time.monotonic() - t_ref
        if program is not None:
            result["program"] = program
        result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
        return result, rows
    finally:
        if leader:
            leader.kill()
        shutil.rmtree(out_dir, ignore_errors=True)
