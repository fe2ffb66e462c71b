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
                    "DIR (trace.json.gz for Perfetto, ops.txt, summary.json)")
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


def profiled(fn, device, top=10):
    """Call `fn()` under torch.profiler; returns (its result, the profiler,
    a summary): the device's busy time (summed kernel time) against the
    call's wall time, the kernel launch count, and the `top` kernels that
    took the most device time."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    on_cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        result = fn()
        if on_cuda:
            torch.cuda.synchronize(device)
        wall_s = time.monotonic() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    summary = dict(
        device=torch.cuda.get_device_name(device) if on_cuda else "cpu",
        wall_s=wall_s, device_busy_s=busy_us / 1e6,
        device_idle_share=1.0 - busy_us / 1e6 / max(wall_s, 1e-9) if on_cuda else None,
        n_kernel_launches=len(kernels),
        top_kernels_s={k: v / 1e6 for k, v in ranked},
    )
    return result, prof, summary


def _profiled(r, out_dir: str) -> list:
    """Render under torch.profiler and write the chrome trace, the op table
    and the summary of `profiled` with the frame stats."""
    import os

    written, prof, summary = profiled(r.initialize_and_render, r.device)
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json.gz"))
    key = "device_time_total" if r.device.type == "cuda" else "cpu_time_total"
    with open(os.path.join(out_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=key, row_limit=60))
    summary["frames"] = r.frame_stats
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return written


if __name__ == "__main__":
    sys.exit(main())
