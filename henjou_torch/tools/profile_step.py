"""Where does a masked MIS spp step go? Component timings on one device.

Port of tools/profile_step.py. On the sphere gallery at 512x512 (LANES =
2^18 pixels in the masked engine's swizzled order, the JAX tool's shape)
it times, each after a warm-up, as the mean of a few calls by CUDA events
(host clock with a synchronise on the CPU):

1. the intersector's throughput on coherent camera rays and incoherent
   random rays, and the any-hit (occlusion) throughput;
2. `closest_hit` (trace + payload fill);
3. the full masked MIS step (`integrator/mis.py`, depth 10), with its
   traces and Mrays/s;
4. the same step with a constant-time fake intersector: the shading side;
5. the payload fill alone (`closest_hit` over the fake intersector);
6. `msggx_sample`, `disney_sample` and the full `bsdf_sample` dispatch;
7. a ray binning pass, sort + gather + scatter of 2^18 random keys: with
   the port's kernels (`bitonic_sort`, `bitonic_unsort`) and with
   `torch.argsort` and indexing.

The intersector is the renderer's: the binned kernel inside the bitonic
sorted wrapper (the JAX tool timed its two-level kernel unsorted).

    python -m henjou_torch.tools.profile_step --device cuda

Prints the card's name and power limit, one line per row, then the rows
as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

LANES = 1 << 18  # 512 x 512


def _timer(dev):
    """time(fn, reps) -> mean ms of fn() after a warm-up on `dev`."""
    if dev.type == "cuda":
        from henjou_torch.tools.time_intersectors import cuda_ms

        return cuda_ms

    def host_ms(fn, reps):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    return host_ms


def run_profile_step(device, lanes: int = LANES, reps: int = 4, log=print) -> dict:
    """The rows above at `lanes` pixels (a square image); returns {row: ms}
    plus the step's traces. Small `lanes` suit the CPU."""
    from henjou_torch.accel import bitonic
    from henjou_torch.accel.pallas_binned import pack_binned_np
    from henjou_torch.accel.sorting import sorted_binned_intersector
    from henjou_torch.bsdf.disney import disney_params, disney_sample
    from henjou_torch.bsdf.dispatch import make_bsdf_sampler
    from henjou_torch.bsdf.msggx import msggx_sample
    from henjou_torch.integrator.mis import mis
    from henjou_torch.integrator.payload import Sky, closest_hit
    from henjou_torch.runtime.camera import camera_rays, make_camera
    from henjou_torch.runtime.renderer import _swizzled_pixel_order, resolve_device
    from henjou_torch.sampling.cmj import make_cmj_state
    from henjou_torch.scene.scenedata import build_device_scene, build_frame_scene
    from henjou_torch.scene.testscenes import sphere_gallery_scene

    dev = resolve_device(device)
    time_ms = _timer(dev)
    rows: dict = {}

    def row(name, fn, n=reps):
        rows[name] = time_ms(fn, n)
        log(f"{name:48s} {rows[name]:10.3f} ms")
        return rows[name]

    frame = build_frame_scene(build_device_scene(sphere_gallery_scene(), dev))
    accel = pack_binned_np(frame.tri_verts.cpu().numpy(), dev)
    intersect_fn, occluded_fn = sorted_binned_intersector(accel)
    log(f"device {dev}: {frame.tri_verts.shape[0]} triangles, {accel.num_clusters} clusters")
    sky = Sky(constant_color=torch.tensor([0.3, 0.4, 0.55], device=dev),
              intensity=torch.tensor(1.0, device=dev))
    cam = make_camera((0.0, 1.2, -9.0), (0.0, -0.05, 1.0), np.radians(45.0), dev)
    side = int(round(lanes ** 0.5))
    pix = torch.from_numpy(_swizzled_pixel_order(side, side)).to(dev)
    st0 = make_cmj_state(0, pix, 7)
    o_cam, d_cam, _ = camera_rays(cam, side, side, pix, st0)
    rng = np.random.default_rng(0)
    o_rand = torch.from_numpy(rng.uniform(-4, 4, (pix.numel(), 3)).astype(np.float32)).to(dev)
    d_np = rng.normal(size=(pix.numel(), 3)).astype(np.float32)
    d_rand = torch.from_numpy(d_np / np.linalg.norm(d_np, axis=1, keepdims=True)).to(dev)
    n = pix.numel()

    for name, (o, d) in (("intersect coherent (camera)", (o_cam, d_cam)),
                         ("intersect incoherent (random)", (o_rand, d_rand))):
        ms = row(name, lambda o=o, d=d: intersect_fn(None, o, d, 1e-3, 1e16))
        log(f"  -> {n / ms / 1e3:.2f} Mrays/s")
    ms = row("occluded incoherent", lambda: occluded_fn(None, o_rand, d_rand, 1e-3, 1e16))
    log(f"  -> {n / ms / 1e3:.2f} Mrays/s")
    row("closest_hit (intersect + payload fill)",
        lambda: closest_hit(frame, sky, o_rand, d_rand, 1e-3, 1e16, intersect_fn))

    bsdf_sample = make_bsdf_sampler(None)

    def step(ifn, ofn):
        st = make_cmj_state(1, pix, 7)
        o, d, st = camera_rays(cam, side, side, pix, st)
        return mis(frame, sky, o, d, st, bsdf_sample, intersect_fn=ifn, occluded_fn=ofn,
                   max_depth=10)

    ms = row("full MIS step (depth 10)", lambda: step(intersect_fn, occluded_fn), max(1, reps - 1))
    traces = int(step(intersect_fn, occluded_fn).n_traces)
    rows["mis_step_traces"] = traces
    log(f"  -> {traces / 1e6:.3f} Mtraces/step, {traces / ms / 1e3:.2f} Mrays/s")

    # a fake O(1) intersector: depends on the ray, reads no scene memory
    t_const = torch.full((n,), 3.0, device=dev)
    prim_fake = torch.from_numpy(rng.integers(0, frame.tri_verts.shape[0], n).astype(np.int32)).to(dev)
    uv = torch.full((n,), 0.3, device=dev)

    def fake_intersect(tv, o, d, tmin, tmax):
        t = t_const + 0.0 * (o[:, 0] + d[:, 0])
        hit = torch.as_tensor(tmax, device=dev).expand(n) > 1.0
        return t, torch.where(hit, prim_fake, -1), uv, uv, hit

    def fake_occluded(tv, o, d, tmin, tmax):
        return (o[:, 0] + d[:, 0]) * torch.as_tensor(tmax, device=dev).expand(n) > 0.5

    row("MIS step w/ FAKE intersector (shading cost)",
        lambda: step(fake_intersect, fake_occluded), max(1, reps - 1))

    wo = d_rand.clone()
    wo[:, 1] = wo[:, 1].abs() + 0.05
    wo = wo / torch.linalg.vector_norm(wo, dim=1, keepdim=True)
    f0 = torch.full((n, 3), 0.9, device=dev)
    rough = torch.full((n,), 0.4, device=dev)
    row("msggx_sample (6-iter walk)", lambda: msggx_sample(f0, rough, wo, st0))
    p = disney_params(f0, rough, rough * 0.0 + 0.2, rough * 0.0, rough * 0.0)
    row("disney_sample", lambda: disney_sample(p, wo, st0))
    hit = closest_hit(frame, sky, o_rand, d_rand, 1e-3, 1e16, fake_intersect)
    row("bsdf_sample full dispatch (all lobes)", lambda: bsdf_sample(hit, wo, st0))
    row("payload fill only (fake intersect)",
        lambda: closest_hit(frame, sky, o_rand, d_rand, 1e-3, 1e16, fake_intersect))

    keys = torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32)).to(dev)
    lane = torch.arange(n, dtype=torch.int32, device=dev)

    def bin_kernels():
        _, o2, d2, lid = bitonic.bitonic_sort(keys, o_rand, d_rand, lane)
        return bitonic.bitonic_unsort(lid, o2 + d2)

    def bin_argsort():
        perm = torch.argsort(keys)
        out = torch.empty_like(o_rand)
        out[perm] = o_rand[perm] + d_rand[perm]
        return out

    row("sort+gather+scatter (bitonic_sort, unsort)", bin_kernels)
    row("sort+gather+scatter (argsort, indexing)", bin_argsort)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    rows = run_profile_step(args.device, log=lambda line: print(line, flush=True))
    print(json.dumps({"lanes": LANES, "device": args.device, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
