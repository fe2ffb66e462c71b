"""Time the four cluster intersector kernels (binned, flat, two-level,
matrix form) on test rays in two orders: as drawn, and as the main path
hands them to a kernel.

    python -m henjou_torch.tools.time_intersectors --device cuda

For the sphere gallery and contest frame 0, 65,536 test rays (half
jittered camera rays through random pixels, half with origins uniform in
the scene box and uniform directions; `test_rays`) go through
``intersect_binned``, ``intersect_pallas``, ``intersect_pallas_hbm`` and
``intersect_pallas_mxu``, each over its own pack of the frame's
triangles, closest and any hit, unsorted and sorted as
`make_bitonic_sorted_intersector` sorts them (`sorted_rays`:
`ray_sort_key` over the scene box, `DEAD_KEY` lanes last, one
`bitonic_sort` carrying the lane id). Each time is the mean of
``--reps`` calls after a warm-up, by CUDA events around the wrapper's
calls (`ms`, host launches included) and as the replay of a CUDA graph of
one call (`graph_ms`, the device's time alone). Prints the card's name
and power limit, then one JSON line per (scene, kernel, hit, order).

chip_smoke.py takes its rays and timers from here. The tool uses only
entry points that every version of the port has, so a copy of it can
time an older checkout's kernels beside the current ones.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

GALLERY = "scenes/sphere_gallery_option.json"
CONTEST = "scenes/rtcamp_720_option.json"
N_RAYS = 1 << 16


def test_rays(renderer, accel, cam, dev, rng, n=N_RAYS):
    """n rays: half jittered camera rays through random pixels, half with
    origins uniform in the scene box and uniform directions."""
    from henjou_torch.runtime.camera import camera_rays
    from henjou_torch.sampling.cmj import make_cmj_state

    half = n // 2
    w, h = renderer.option.image_width, renderer.option.image_height
    pix = torch.from_numpy(rng.integers(0, w * h, half)).to(dev)
    o_c, d_c, _ = camera_rays(cam, w, h, pix, make_cmj_state(0, pix, 0))
    lo = accel.scene_lo.cpu().numpy()
    hi = accel.scene_hi.cpu().numpy()
    o_r = rng.uniform(lo, hi, (half, 3)).astype(np.float32)
    d_r = rng.normal(size=(half, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    o = torch.cat([o_c, torch.from_numpy(o_r).to(dev)]).contiguous()
    d = torch.cat([d_c, torch.from_numpy(d_r).to(dev)]).contiguous()
    return o, d


def sorted_rays(o, d, tmin, tmax, lo, hi):
    """(o, d, src) in the order `make_bitonic_sorted_intersector` hands
    the kernel: by `ray_sort_key`, rays with tmax <= tmin last, through the
    bitonic sort with the lane id carried; src [n] int32 is each sorted
    ray's row in o, d. [n] tmin and tmax; n a power of two of at least
    1024."""
    from henjou_torch.accel import bitonic
    from henjou_torch.accel.sorting import DEAD_KEY, ray_sort_key

    inv_extent = 1.0 / torch.clamp(hi - lo, min=1e-12)
    key = torch.where(tmax > tmin, ray_sort_key(o, d, lo, inv_extent), DEAD_KEY)
    lane = torch.arange(o.shape[0], dtype=torch.int32, device=o.device)
    _, so, sd, src = bitonic.bitonic_sort(key.contiguous(), o, d, lane)
    return so, sd, src


def ray_orders(accel, o, d):
    """{"unsorted": (o, d, arange), "sorted": `sorted_rays` of them}: each
    order's rays and their rows in o, d, for tmin 1e-3 and the default
    tmax, over the scene box of the binned pack `accel`."""
    from henjou_torch.math.constants import TMAX_RAY

    n = o.shape[0]
    tmin = torch.full((n,), 1e-3, device=o.device)
    tmax = torch.full((n,), TMAX_RAY, device=o.device)
    return {"unsorted": (o, d, torch.arange(n, dtype=torch.int32, device=o.device)),
            "sorted": sorted_rays(o, d, tmin, tmax, accel.scene_lo, accel.scene_hi)}


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn()` over `reps` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int = 20):
    """Mean ms of one replay of `fn()` captured in a CUDA graph: the time
    its kernels hold the device without the host's per-launch cost (a
    replay submits them all at once). None when the call cannot be
    captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as e:
        print(f"[graph] capture failed: {e}", flush=True)
        return None
    return cuda_ms(graph.replay, reps)


def run(device, reps: int = 20, seed: int = 2):
    """Yield one dict per (scene, kernel, hit, order)."""
    from henjou_torch.accel import pallas_binned as pb
    from henjou_torch.accel import pallas_cluster as pc
    from henjou_torch.accel import pallas_cluster_hbm as hbm
    from henjou_torch.accel import pallas_mxu as mxu
    from henjou_torch.math.constants import TMAX_RAY
    from henjou_torch.runtime.renderer import Renderer

    rng = np.random.default_rng(seed)
    for label, path in (("gallery", GALLERY), ("contest", CONTEST)):
        r = Renderer(device=device)
        r.load_render_option(path)
        r._load_scene_from_option()
        fs, accel, cam = r.frame_scene(0)
        o, d = test_rays(r, accel, cam, device, rng)
        n = o.shape[0]
        tmin = torch.full((n,), 1e-3, device=device)
        tmax = torch.full((n,), TMAX_RAY, device=device)
        orders = ray_orders(accel, o, d)
        tris = fs.tri_verts.cpu().numpy()
        for kernel, fn, packed in (
                ("binned", pb.intersect_binned, accel),
                ("cluster", pc.intersect_pallas, pc.pack_clusters(fs.tri_verts)),
                ("cluster_hbm", hbm.intersect_pallas_hbm, hbm.pack_clusters_hbm_np(tris, device)),
                ("mxu", mxu.intersect_pallas_mxu, mxu.pack_clusters_mxu_np(tris, device))):
            for any_hit in (False, True):
                for order, (ro, rd, _) in orders.items():
                    # tmin and tmax on the device: a graph captures no host copy
                    def call():
                        return fn(packed, ro, rd, tmin, tmax, any_hit=any_hit)

                    yield dict(scene=label, kernel=kernel, hit="any" if any_hit else "closest",
                               order=order, rays=n, ms=cuda_ms(call, reps),
                               graph_ms=graph_ms(call, reps))


def main(argv=None) -> int:
    from henjou_torch.runtime.renderer import resolve_device

    ap = argparse.ArgumentParser(description="time the cluster intersector kernels")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("time_intersectors: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    for row in run(device, args.reps):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
