"""CLI entry: ``python -m henjou_torch.render [render_option.json]``.

Port of henjou_tpu/render.py. With no option file it renders the built-in
Cornell smoke scene. ``--device`` picks the torch device (default
``cuda``; the JAX CLI honours JAX_PLATFORMS for the same purpose); asking
for CUDA where it is not available is an error.

With ``--device cuda``, more than one visible GPU and ``TPU.multichip``
"auto" (the default), the CLI starts one worker process per GPU, joined
in an NCCL group on a free localhost port; the workers shard every spp
batch over the group, and rank 0 writes the PNGs, checkpoints and stats.
A process that already belongs to a `torch.distributed` group renders
its share in that group instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys


def _parse(argv):
    ap = argparse.ArgumentParser(description="Henjou renderer (PyTorch/CUDA)")
    ap.add_argument("option", nargs="?", help="render_option.json path")
    ap.add_argument("--spp", type=int, help="override max_spp")
    ap.add_argument("--size", type=str, help="override WxH, e.g. 512x512")
    ap.add_argument("--out", type=str, help="override image_name")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to render on (default: cuda)")
    ap.add_argument("--stats", type=str, metavar="PATH",
                    help="write per-frame timings, trace counts and film "
                    "checks as JSON to PATH")
    ap.add_argument("--profile", type=str, metavar="DIR",
                    help="capture a torch.profiler trace of the render into "
                    "DIR (trace.json.gz for Perfetto, ops.txt, spans.json, "
                    "summary.json with the device's idle time by span)")
    return ap.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="[%(levelname).1s] %(name)s: %(message)s")
    args = _parse(argv)
    n_gpus = _spawn_count(args)
    if n_gpus > 1:
        return _spawn(argv, n_gpus)
    return _run(args)


def _spawn_count(args) -> int:
    """The number of worker processes to start: every visible GPU for
    ``--device cuda`` with multichip "auto" outside a process group, else
    0 (render in this process)."""
    import torch
    import torch.distributed as dist

    if args.device != "cuda" or not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        return 0
    if dist.is_available() and dist.is_initialized():
        return 0
    from henjou_torch.runtime.options import RenderOption, load_render_option

    opt = load_render_option(args.option) if args.option else RenderOption()
    return torch.cuda.device_count() if opt.multichip == "auto" else 0


def _spawn(argv, n_gpus: int) -> int:
    """Render with one worker per GPU (rank k on cuda:k)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    logging.getLogger("henjou_torch").info("multi-GPU: %d worker processes", n_gpus)
    mp.spawn(_worker, args=(n_gpus, f"tcp://localhost:{port}", argv), nprocs=n_gpus)
    return 0


def _worker(rank: int, world: int, init_method: str, argv):
    import torch
    import torch.distributed as dist

    logging.basicConfig(level=logging.INFO, format=f"[%(levelname).1s] r{rank} %(name)s: "
                        "%(message)s")
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=init_method, world_size=world, rank=rank)
    try:
        args = _parse(argv)
        args.device = f"cuda:{rank}"
        _run(args)
    finally:
        dist.destroy_process_group()


def _run(args) -> int:
    from henjou_torch.runtime.renderer import Renderer
    from henjou_torch.runtime.sharding import world

    r = Renderer(device=args.device)
    if args.option:
        r.load_render_option(args.option)
        r._load_scene_from_option()
    else:
        from henjou_torch.runtime.options import RenderOption
        from henjou_torch.scene.testscenes import cornell_box_scene

        r.option = RenderOption(
            image_width=256,
            image_height=256,
            image_name="cornell",
            max_spp=64,
            camera_position=(0.0, 0.0, -4.5),
            camera_direction=(0.0, 0.0, 1.0),
            scene_sky_default=(0.0, 0.0, 0.0),
            time_limit=10.0,
        )
        r.set_scene(cornell_box_scene())
        r.build()

    overrides = {}
    if args.spp:
        overrides["max_spp"] = args.spp
    if args.size:
        w, h = args.size.lower().split("x")
        overrides["image_width"] = int(w)
        overrides["image_height"] = int(h)
    if args.out:
        overrides["image_name"] = args.out
    if overrides:
        r.option = dataclasses.replace(r.option, **overrides)

    if args.profile and world()[1] == 0:
        written = _profiled(r, args.profile)
    else:
        written = r.initialize_and_render()
    if world()[1] != 0:
        return 0  # rank 0 reports
    print("wrote:", ", ".join(written))
    if args.stats:
        with open(args.stats, "w") as f:
            json.dump({"setup": r.setup_stats, "frames": r.frame_stats}, f, indent=1)
    return 0


def _profiled(r, out_dir: str) -> list:
    """Render under torch.profiler and write into `out_dir` the chrome
    trace, the op table, spans.json (every frame's spans and counters,
    `utils/timer.py`) and summary.json: the frame stats without their
    spans and, on CUDA, the device's idle seconds between its first and
    last operation by the innermost span open over them."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    on_cuda = r.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=acts) as prof:
        written = r.initialize_and_render()
        if on_cuda:
            torch.cuda.synchronize(r.device)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json.gz"))
    key = "device_time_total" if on_cuda else "cpu_time_total"
    with open(os.path.join(out_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=key, row_limit=60))
    traced = [dict(frame=s["frame"], spans=s.get("spans", []), counters=s.get("counters", {}))
              for s in r.frame_stats]
    with open(os.path.join(out_dir, "spans.json"), "w") as f:
        json.dump(traced, f)
    summary = dict(device=torch.cuda.get_device_name(r.device) if on_cuda else "cpu",
                   idle_s_by_span=None,
                   frames=[{k: v for k, v in s.items() if k not in ("spans", "counters")}
                           for s in r.frame_stats])
    if on_cuda:
        busy = [(e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()
                if str(e.device_type()).endswith("CUDA")]
        summary["idle_s_by_span"] = _idle_by_span([s for t in traced for s in t["spans"]], busy)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return written


def _innermost(spans) -> list:
    """[(start, end, name)] over the union of `spans` ([name, parent,
    start, end], nested as they were opened), each piece named by the
    innermost span open over it: a span's self time is the length of its
    pieces."""
    out, stack, cur = [], [], None
    for name, _, start, end in sorted(spans, key=lambda s: (s[2], -s[3])):
        while stack and stack[-1][1] <= start:
            top, top_end = stack.pop()
            if top_end > cur:
                out.append((cur, top_end, top))
                cur = top_end
        if stack and start > cur:
            out.append((cur, start, stack[-1][0]))
        cur = start
        stack.append((name, end))
    while stack:
        top, top_end = stack.pop()
        if top_end > cur:
            out.append((cur, top_end, top))
            cur = top_end
    return out


def _idle_by_span(spans, busy) -> dict:
    """Seconds of the gaps between the union of the device's `busy`
    (start, end) intervals, by the innermost span open over each part of a
    gap ("(no span)" where none is), largest first."""
    gaps, end = [], None
    for s, e in sorted(busy):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    by: dict = {}
    pieces = _innermost(spans)
    j = 0
    for g0, g1 in gaps:
        covered = 0
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            lap = min(g1, pieces[k][1]) - max(g0, pieces[k][0])
            by[pieces[k][2]] = by.get(pieces[k][2], 0) + lap
            covered += lap
            k += 1
        by["(no span)"] = by.get("(no span)", 0) + (g1 - g0 - covered)
    return {k: v * 1e-9 for k, v in sorted(by.items(), key=lambda kv: -kv[1])}


if __name__ == "__main__":
    sys.exit(main())
