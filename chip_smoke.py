"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Runs from the repository root and needs CUDA; without it (or without the
repository's ``henjou_torch`` package beside it) it exits non-zero and
prints no result. Phases, each of which raises on failure:

1. the device: name and power limit;
2. the build of ``henjou_torch/csrc/*.cu`` with nvcc, one process per
   source (seconds);
3. the bitonic sort (one cooperative launch of the keyed network engine,
   ``csrc/keyed_network.cuh``) against its plain version at n = 1024 and
   65536 with 10 columns (the key, [n, 3] origin and direction rows, two
   planes and the lane id), at 2^18 with keys over the whole int32
   range, and at 131,072 with the masked engine's 9 columns (a scalar
   tmin; 24-bit keys and dead lanes): keys and planes bit-equal, every
   (key, payload) pair kept, and the inverse sort restoring the input
   exactly; the sort and the inverse timed by CUDA events and as CUDA
   graph replays (`masked_ms` at 131,072);
4. the binned intersector kernel against its plain version, closest and
   any hit, on 65536 rays (half camera rays, half incoherent random rays;
   `henjou_torch.tools.time_intersectors.test_rays`) on the sphere
   gallery and on contest frame 0, once as drawn and once sorted as the
   main path's sorted wrapper hands them to the kernel (`sorted_rays`):
   t, prim, u, v and hit bit-equal (the kernel is the warp-per-ray walk of
   ``csrc/cluster_walk.cuh``), and within the general limits: t within a
   relative 1e-5 where both hit, hit flips at most 1e-4 of the rays, prim
   equal except where the other triangle is hit at the same t, and u, v
   within 1e-6 where both hit the same triangle; and the kernel's results
   on the sorted rays, put back in drawn order, bit-equal to its results on
   the rays as drawn (a ray's result does not depend on the other rays);
5. the three cluster intersectors (flat scan ``cluster.cu``, two-level
   ``cluster_hbm.cu``, matrix form ``mxu.cu``, each an entry point over
   the same walk) against their plain versions on the same scenes, as
   phase 4: bit-equal and within its limits, on both orders, with the
   same order check;
6. the wavefront engine on the gallery at 64x36, 4 spp, 4096 lanes, once
   with the kernels and once with the plain versions passed explicitly:
   per-pixel RMSE of the mean colour at most 5e-3 (atomic film sums and a
   rare hit flip reorder the arithmetic), sample counts equal;
7. the same for two-sample MIS (``mis_single=False``) with each cluster
   intersector inside the argsort wrapper `make_sorted_intersector`;
8. the binned light query (kernel 1 over the emissive subset) against the
   dense `intersect_lights` on the gallery's rays and on a scene of 1,100
   emissive triangles: hit flips at most 1e-4 of the rays, prim equal up
   to ties, t within a relative 1e-4 (Baldwin-Weber against
   Moller-Trumbore, two formulas) and the light's area within 1e-5;
9. the gallery render through the CLI (``henjou_torch.render.main``) at 16
   spp: a decodable 512x288 PNG, a finite film, spp/s and Mrays/s; every
   ``initialize_and_render`` on the card first runs the hardware canary
   (``henjou_torch/runtime/canary.py``, which raises when its film is off),
   and its RMSE is logged once;
10. the contest option file as shipped (``scenes/rtcamp_720_option.json``:
    DenoiseTemporal, two frames of the animated camera) at 1280x720, 4 spp,
    through the Renderer API: two decodable PNGs, finite films and
    finalized images, the binned kernel launched inside ``_finalize`` (the
    temporal depth probe) on both frames, frame 1 through
    ``temporal_accumulate``; per frame the render, finalize and PNG
    seconds;
11. the scale test (``henjou_torch.tools.scale_test``) at full width: a
    194,044-triangle scene at 1920x1080, 1 spp, two-sample MIS, in two
    rows (binned+bitonic, and the two-level kernel in the argsort
    wrapper), each rendered once untimed and once timed: finite films,
    seconds, traces, Mrays/s and the RMSE between the rows;
12. contest frame 0 with ``mis_mode="ref"``, Default mode, 2 spp;
13. the payload-carrying bitonic network (``csrc/bitonic_net.cu``, four
    kernels): every row of the four bitonic-schedule tools
    (``henjou_torch.tools.exp_bitonic``, ``exp_bitonic2``,
    ``exp_bitonic3``, ``exp_bitonic4``) at full shape (65,536 elements, 10
    planes, and 5 where exp_bitonic has them; 136 substages) through its
    entry-point function, then again with the plain versions: every
    row's output bit-equal on every plane, the keys sorted on the
    full-sort rows, and beside those rows the production
    ``bitonic.bitonic_sort`` and ``torch.argsort(stable=True)`` plus
    indexing timed on the same planes; then each kernel alone, in every
    form its wrapper takes, against its plain version at 65,536 x 10;
    then each full-sort design and each 136-launch row timed twice, by
    CUDA events around the calls and as the replay of a CUDA graph, which
    leaves out the host's per-launch cost; and the device time per launch
    of ``net_substage``, ``net_local`` and ``roll_pass`` inside rows A, C,
    D, E and G and the host walk, from torch.profiler's kernel events;
14. the gallery through the CLI in Denoise, DenoiseUpScale2X and Debug at
    4 spp (copies of its option file): a 512x288 PNG (UpScale2X rendered
    at 256x144), and four 512x288 PNGs for Debug; it runs between phases 9
    and 10;
15. the denoiser on the card against the CPU, on frame 0's AOVs from phase
    10 and a known synthetic reprojection (+1.3, -0.6 pixels):
    ``denoise_atrous_var``, ``temporal_accumulate``,
    ``denoise_temporal_reprojected``, ``upscale2x_guided`` (from the AOVs
    at half size, guided by the full-size ones) and ``upscale2x`` on CUDA
    and CPU tensors, within the CPU parity tests' rtol 1e-4, atol 1e-5, and
    each one's ms per call at 1280x720 by CUDA events; it runs after
    phase 10;
16. the OBJ option file as shipped (``scenes/cornelbox_obj_option.json``:
    256x256, 64 spp, MIS, 540 triangles) through the CLI: the PNG
    decoded, the light patch bright, the set-up seconds; then the C HDR
    decode (``henjou_torch/native``) byte-equal to the Python loop on the
    contest's sky, both timed;
17. the gallery at 512x288 with ``engine="masked"`` against
    ``engine="wavefront", mis_mode="ref"``: MIS at 2 spp, pathtrace and
    nee at 1; per-pixel RMSE of the means at most 1e-5 (the same streams
    through the same kernels), trace counts equal, spp/s and Mrays/s of
    both;
18. the contest option file with only its engine set to masked, 1 spp:
    frames 0 and 1 at 1280x720 in DenoiseTemporal, whose blend-only branch
    frame 1 takes (the masked film has no variance AOV); 131,072-ray sorts;
19. the contest scene with a keyframed translation on its mesh instance,
    frames 0-2 at 1280x720, 1 spp, wavefront engine: the host pack runs
    at most once, then the cluster order is planned and each new
    transform set refreshes the pack on the device; each refreshed pack's
    boxes equal, and its rows within 64 ulps of their scale of, the same
    refresh by torch ops on the CPU; the binned kernel on it against its
    plain version within phase 4's limits; the refresh timed by CUDA
    events beside the host pack's seconds;
20. ``sampler="sobol"``: Sobol draws (tagged and untagged states, three
    draws) on the card bit-equal to the CPU over 2^16 states; the gallery
    through the kernels against the plain versions passed explicitly
    (64x36, 4 spp, RMSE at most 5e-3 as phase 6); the gallery at 512x288,
    4 spp, through `render_frame` with and without it (spp/s of both);
21. contest frame 0 (Default mode) with ``light_ris=8`` and with adaptive
    sample counts through the kernels against the plain versions (32x18, 2
    spp, as phase 6); then at 1280x720: the default at 1 spp, RIS at 1
    spp and ``adaptive=True`` over a 2-spp warm-up and a 1-spp batch by
    variance, whose counts are at least the warm-up's 2, uneven, and sum
    to at most the budget and less than one sample a pixel under it;
22. the gallery with ``HENJOU_POOL_SORT=1``: the raw binned kernel with the
    lane pool sorted after every bounce (27 columns through
    `bitonic_sort`: one network and one gather launch per call) against
    the plain versions (64x36, 4 spp, 4096 lanes), then at 512x288 (65,536
    lanes), 4 spp, against the per-trace sorted film: RMSE at most 1e-5,
    traces equal;
23. two processes in a gloo group on ``cuda:0`` shard the gallery's 4
    spp (512x288, ``spp_batch=1``) against one process: RMSE at most 1e-5,
    counts and traces equal (NCCL refuses two ranks on one card); then the
    same processes render an adaptive frame (64x36, 4 spp in 1-spp
    batches, not sharded) through ``initialize_and_render`` with one
    checkpoint path: rank 1 renders 0 spp and writes no checkpoint, rank 0
    writes it once per batch, none is left, and rank 0's film equals one
    process's (RMSE at most 1e-5, counts and traces equal);
24. the public API: ``cmj_3d`` and ``cmj_4d`` on 65,536 states (the Sobol
    tag on half) bit-equal to the CPU, ``sample_atlas`` on CUDA within
    1e-6 of the CPU, ``wavefront_pathtrace`` on the gallery with its
    default intersector (binned inside the bitonic sorted wrapper) against
    the plain versions (64x36, 4 spp, 4096 lanes, as phase 6), then at
    512x288, 4 spp, 65,536 lanes with spp/s and Mrays/s;
25. the CMJ draw kernel (``csrc/cmj.cu``) at 131,072 and 921,600 lanes
    (the masked tile and a 1280x720 frame), `cmj_2d` and `cmj_4d` on a
    state as the engines make it: values and the new depth bit-equal to
    the torch code on the same state; each timed per call by CUDA events
    (the wrapper's host cost included, as the engines pay it), as the
    replay of a CUDA graph (the device alone), and the torch code by CUDA
    events, beside the bound (its bytes at 3.35 TB/s);
26. the BSDF kernels (``csrc/bsdf.cu``) at 65,536 and 131,072 lanes with
    the contest scene's lobes (meta-glass, metals, Disney with the
    thin-film LUT): `bsdf_sample`, `bsdf_eval` and `bsdf_pdf` each one
    launch, bit-equal to the plain torch code on the same device (the
    sample's new depth too); kernel and torch code each timed by CUDA
    events and as a CUDA graph replay, the torch code's launches counted,
    beside the bound (the lanes' bytes at 3.35 TB/s); then the three
    kernels' registers and spill bytes from ``nvcc -Xptxas -v``.

Launch counters are zeroed just before, and read just after, each path
that drives kernels through a user's entry point: phase 7's kernel
renders (the cluster intersectors, which no renderer routes), phases 9,
14 and 10 (the main path: bitonic and binned, the canaries and the
finalize probes included), phases 11-12 (the scale path: bitonic,
binned and the two-level kernel), and each of this slice's paths on its
own: phase 16 (OBJ), each masked render of phase 17 (not its wavefront
twins), phase 18 (masked at contest scale) and phase 19's renders (not
its comparisons), and phases 20-24: each option's render (Sobol, RIS,
adaptive, the pool re-sort, whose bitonic launches are all 27-column
pool sorts), the two sharding processes' renders, summed, and phase 24's
full-size `wavefront_pathtrace` (``api``). Each kernel
of a path must have grown there; every path draws and shades, so the CMJ
and BSDF kernels count with them. The kernels line reports, as
`launches`, the bitonic, binned, CMJ and BSDF counts of the main path, with each
of phases 16-24's under `launches_by_path`; the
two-level kernel's of phases 11-12, the flat and matrix kernels' of
phase 7, and the network kernels' of
phase 13 (its tools' rows are that path). The line before the last is the
card's name and power limit; before that, one JSON line with each
kernel's launches, error against its plain version, times (`ms` on the
unsorted rays; for the four walk kernels also `sorted_ms` on the sorted
ones), the bound
(the least time the card could take for the same work: bytes moved at
3.35 TB/s against operations at 67 TFLOP/s f32, whichever is larger; an
intersector's operations are its triangle tests, counted as the
(ray, cluster) visits of its plain version times 128 triangles times the
flops of one test) and the time of one library call that computes the
same function, where there is one. The last line is the result JSON.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from henjou_torch.tools.time_intersectors import N_RAYS, cuda_ms, graph_ms

TOL_T_REL = 1e-5
TOL_FLIPS = 1e-4
TOL_UV = 1e-6  # absolute, where both hit the same triangle
TOL_ENGINE_RMSE = 5e-3
# masked engine against the wavefront two-sample form on the gallery: the
# same CMJ streams through the same kernels, whose results do not depend on
# the other rays; runs AW-AY read 6.7e-9 to 3.3e-8 RMSE (PERF.md)
TOL_MASKED_RMSE = 1e-5
# the pool-sorted film against the per-trace sorted one: the same rays and
# per-ray results, only the atomic film sums reorder
TOL_POOL_RMSE = 1e-5
# two processes sharding the spp against one process: the same samples,
# summed in another order
TOL_SHARD_RMSE = 1e-5
GALLERY = "scenes/sphere_gallery_option.json"
CONTEST = "scenes/rtcamp_720_option.json"
OBJ = "scenes/cornelbox_obj_option.json"
# refreshed pack rows on CUDA against the CPU: ulps of each value's scale
# (tests/test_torch_anim_accel.py's limit against the JAX refresh)
ROW_ULPS = 64
GALLERY_SIZE = (512, 288)  # the gallery option file's width and height
# binned light query against dense Moller-Trumbore: two formulas, as in
# tests/test_torch_accel.py's binned-vs-brute-force limit
TOL_T_REL_FORMULAS = 1e-4
CLUSTER_KERNELS = ("cluster", "cluster_hbm", "mxu")
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and f32 FLOP/s outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
TRIS_PER_CLUSTER = 128
# flops of one ray/triangle test, counted from the kernels' code: the
# binned kernel's Baldwin-Weber test (binned.cu), Moller-Trumbore
# (common.cuh `mt`), the matrix form's four ten-term sums and epilogue
FLOPS_PER_TEST = {"binned": 32, "cluster": 46, "cluster_hbm": 46, "mxu": 81}
RAY_BYTES = 32 + 16  # o, d, tmin, tmax in; t, prim, u, v out
NET_TOOLS = ("exp_bitonic", "exp_bitonic2", "exp_bitonic3", "exp_bitonic4")
# the network kernels' CUDA function names (net_walk's is the keyed
# engine's `network`, not profiled here)
NET_KERNEL_NAMES = {"net_substage": ("substage_stacked", "substage_per_plane", "substage_guarded"),
                    "net_local": ("local_list",), "roll_pass": ("roll_stacked", "roll_per_plane")}
NET_REPLACES = {
    "net_substage": "tools/exp_bitonic2.py:73 (kern_a), :91 (kern_b), :120 (kern_d), "
                    ":201 (kern_g); tools/exp_bitonic4.py:105 (make_loop over x1, x2 and "
                    "the guard chains :144); tools/exp_bitonic.py:82 (kern_unroll, j >= 1024)",
    "net_local": "tools/exp_bitonic2.py:109 (kern_c); tools/exp_bitonic.py:82 "
                 "(kern_unroll, j < 1024)",
    "net_walk": "tools/exp_bitonic.py:53 (kern_switch); tools/exp_bitonic3.py:59 "
                "(kern_inplace), :66 (kern_inplace_aliased); tools/exp_bitonic4.py:138 "
                "(make_loop over x5)",
    "roll_pass": "tools/exp_bitonic2.py:156 (kern_e), :173 (kern_f)",
}


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def bound(n_bytes: float, n_ops: float = 0.0) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time for `n_bytes` of memory traffic
    and `n_ops` f32 operations at the card's peaks."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def intersect_bound(packed, n_rays: int, visits: int, kind: str) -> tuple[float, str]:
    """The bound of one trace: the rays and hits in and out and every pack
    tensor read once, against the triangle tests of `visits` (ray,
    cluster) pairs."""
    pack_bytes = sum(t.numel() * t.element_size() for t in vars(packed).values()
                     if isinstance(t, torch.Tensor))
    return bound(n_rays * RAY_BYTES + pack_bytes,
                 visits * TRIS_PER_CLUSTER * FLOPS_PER_TEST[kind])


def _fmt_ms(ms) -> str:
    return "n/a" if ms is None else f"{ms:.4f} ms"


def argsort_gather(key, *planes):
    """The library yardstick of a sort: torch.argsort(stable=True) and
    indexing (the port never calls it on a CUDA tensor)."""
    perm = torch.argsort(key, stable=True)
    return (key[perm],) + tuple(p[perm] for p in planes)


def phase_sort(dev, results):
    from henjou_torch.accel import bitonic

    from henjou_torch.accel.sorting import DEAD_KEY

    rng = np.random.default_rng(1)
    worst = 0.0
    for n, kind in ((1024, "ties"), (1 << 18, "signed"), (1 << 17, "masked"), (65536, "ties")):
        # the renderer's forward sort of a trace with a per-ray tmin: the
        # key, origin and direction rows [n, 3], tmin, tmax and the lane
        # id (10 columns); here the last plane but one holds random bits.
        # Keys with many ties (a sort key has 24 bits over 65536 rays), or
        # over the whole int32 range. "masked": the masked engine's trace
        # of a 131,072-ray tile, a scalar tmin, so the key, origin and
        # direction rows, tmax and the lane id (9 columns), 24-bit keys
        # with dead lanes (DEAD_KEY, tmax 0).
        lo, hi = {"signed": (-2**31, 2**31 - 1), "ties": (0, n // 4), "masked": (0, 1 << 24)}[kind]
        key = rng.integers(lo, hi, n).astype(np.int32)
        planes = [torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(dev)
                  for _ in range(2)]
        if kind == "masked":
            dead = rng.random(n) < 0.3
            key[dead] = DEAD_KEY
            planes.append(torch.from_numpy(np.where(dead, 0.0, 1e16).astype(np.float32)).to(dev))
        else:
            planes.append(torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev))
            planes.append(torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)).to(dev))
        key = torch.from_numpy(key).to(dev)
        lane = torch.arange(n, dtype=torch.int32, device=dev)
        out = bitonic.bitonic_sort(key, *planes, lane)
        torch.cuda.synchronize()
        ref = bitonic.bitonic_sort_plain(key, *planes, lane)
        worst = max(worst, max(float((a.double() - b.double()).abs().max())
                               for a, b in zip(out, ref)))
        for a, b in zip(out, ref):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"sort n={n}: kernel differs from the plain version")
        if not bool((out[0][1:] >= out[0][:-1]).all()):
            raise AssertionError(f"sort n={n}: keys not sorted")
        # every (key, payload) pair kept: the lane id maps each output row
        # back to its input row
        src = out[-1].long()
        if not bool((torch.bincount(src, minlength=n) == 1).all()):
            raise AssertionError(f"sort n={n}: lane ids are not a permutation")
        for p_in, p_out in zip((key, *planes), out[:-1]):
            if not torch.equal(p_in[src].view(torch.int32), p_out.view(torch.int32)):
                raise AssertionError(f"sort n={n}: a (key, payload) pair was broken")
        inv = bitonic.bitonic_unsort(out[-1], *out[1:-1])
        torch.cuda.synchronize()
        for p_in, p_back in zip(planes, inv):
            if not torch.equal(p_in.view(torch.int32), p_back.view(torch.int32)):
                raise AssertionError(f"sort n={n}: the inverse did not restore the input")
        n_cols = sum(1 if p.dim() == 1 else p.shape[1] for p in (key, *planes, lane))
        log(f"[sort] n={n} {n_cols} columns, {kind} keys: keys, pairs and inverse exact")
        if kind == "masked":
            sort_fn = functools.partial(bitonic.bitonic_sort, key, *planes, lane)
            masked = dict(masked_ms=cuda_ms(sort_fn, 20), masked_graph_ms=graph_ms(sort_fn),
                          masked_library_ms=cuda_ms(
                              functools.partial(argsort_gather, key, *planes, lane), 20))
            log(f"[sort] n={n} x{n_cols} columns (the masked engine's trace): kernel "
                f"{masked['masked_ms']:.4f} ms, {_fmt_ms(masked['masked_graph_ms'])} as a CUDA "
                f"graph, argsort+gather {masked['masked_library_ms']:.4f} ms (CUDA events)")
    # times at the renderer's shape: 65536 rays, the 10 columns above
    # forward, and 4 planes (t, prim, u, v) back
    ms = cuda_ms(lambda: bitonic.bitonic_sort(key, *planes, lane), 20)
    plain_ms = cuda_ms(lambda: bitonic.bitonic_sort_plain(key, *planes, lane), 20)
    library_ms = cuda_ms(lambda: argsort_gather(key, *planes, lane), 20)
    n_cols = sum(1 if p.dim() == 1 else p.shape[1] for p in (key, *planes, lane))
    lid = out[-1]
    back4 = (out[3], out[4], out[3], out[4])
    un_ms = cuda_ms(lambda: bitonic.bitonic_unsort(lid, *back4), 20)
    un_plain = cuda_ms(lambda: bitonic.bitonic_unsort_plain(lid, *back4), 20)
    graphs = {name: graph_ms(fn) for name, fn in (
        ("kernel", lambda: bitonic.bitonic_sort(key, *planes, lane)),
        ("argsort+gather", lambda: argsort_gather(key, *planes, lane)),
        ("inverse", lambda: bitonic.bitonic_unsort(lid, *back4)))}
    log(f"[sort] n=65536 x{n_cols} columns: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"argsort+gather {library_ms:.4f} ms; "
        f"inverse x4 planes: kernel {un_ms:.4f} ms, plain {un_plain:.4f} ms (CUDA events)")
    log("[sort] as CUDA graphs: " + ", ".join(f"{k} {_fmt_ms(v)}" for k, v in graphs.items()))
    bound_ms, bound_by = bound(2 * n_cols * key.numel() * 4)
    results["bitonic"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                              inverse_ms=un_ms, inverse_plain_ms=un_plain,
                              graph_ms=graphs["kernel"], inverse_graph_ms=graphs["inverse"],
                              **masked)


def _bit_equal(name, k, p):
    """The walk kernels (every intersector, csrc/cluster_walk.cuh) equal
    their plain versions to the bit."""
    for field, a, b in zip(("t", "prim", "u", "v", "hit"), k, p):
        if not torch.equal(a, b):
            raise AssertionError(f"[{name}] {field} differs from the plain version")


def _same_back(name, unsorted, on_sorted, src):
    """A walk kernel's results `on_sorted` on the sorted rays, put back at
    their rows `src` of the rays as drawn, equal its results `unsorted`
    there to the bit."""
    for field, a, b in zip(("t", "prim", "u", "v", "hit"), unsorted, on_sorted):
        back = torch.empty_like(b)
        back[src.long()] = b
        if not torch.equal(a, back):
            raise AssertionError(f"[{name}] {field} on the sorted rays differs from the rays "
                                 "as drawn")


def _check_intersections(name, tri_verts, o, d, k, p, any_hit):
    """Kernel result `k` against plain result `p` (t, prim, u, v, hit).
    Returns the largest absolute difference in t, u or v where both hit
    the same triangle."""
    from henjou_torch.accel.bruteforce import _mt_chunk

    flips = int((k[4] != p[4]).sum())
    if flips > TOL_FLIPS * o.shape[0]:
        raise AssertionError(f"[{name}] {flips} hit flips of {o.shape[0]} rays")
    both = k[4] & p[4]
    err = (k[0][both] - p[0][both]).abs()
    rel = float((err / p[0][both].abs().clamp(min=1e-30)).max()) if both.any() else 0.0
    if rel > TOL_T_REL:
        raise AssertionError(f"[{name}] t differs by a relative {rel}")
    same = both & (k[1] == p[1])
    uv_err = max(float((k[i][same] - p[i][same]).abs().max()) if same.any() else 0.0
                 for i in (2, 3))
    if uv_err > TOL_UV:
        raise AssertionError(f"[{name}] u or v differs by {uv_err}")
    n_prim = 0
    if not any_hit:
        diff = both & (k[1] != p[1])
        n_prim = int(diff.sum())
        if n_prim:
            # another triangle must be hit at the same t: test the kernel's
            # triangle alone for each such ray
            tv = tri_verts[k[1][diff].long()][:, None]  # [m,1,3,3]
            t_alt, _, _, ok = _mt_chunk(o[diff][:, None], d[diff][:, None],
                                        tv[..., 0, :], tv[..., 1, :], tv[..., 2, :],
                                        0.0, torch.inf)
            tie = ok[:, 0] & ((t_alt[:, 0] - p[0][diff]).abs()
                              <= 1e-4 * p[0][diff].abs())
            if not bool(tie.all()):
                raise AssertionError(f"[{name}] prim differs without a tie in t")
    log(f"[{name}] hits {int(p[4].sum())}/{o.shape[0]}, flips {flips}, "
        f"max rel t err {rel:.3g}, max u/v err {uv_err:.3g}, prim ties {n_prim}")
    return max(float(err.max()) if both.any() else 0.0, uv_err)


def _trace_vs_plain(name, mod, kind, fn, plain, packed, tri_verts, o, d, any_hit, reps):
    """One trace of the kernel wrapper `fn` against its plain version on
    rays o, d (tmin 1e-3): the walk kernels bit-equal, every kernel within
    phase 4's limits; then the kernel timed over `reps` calls. Returns
    (the kernel's result, (max error, kernel ms, plain ms, bound ms,
    bound by))."""
    k = fn(packed, o, d, 1e-3, any_hit=any_hit)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    mod.VISITS = 0
    e0.record()
    p = plain(packed, o, d, 1e-3, any_hit=any_hit)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    visits = mod.VISITS
    _bit_equal(name, k, p)
    err = _check_intersections(name, tri_verts, o, d, k, p, any_hit)
    ms = cuda_ms(lambda: fn(packed, o, d, 1e-3, any_hit=any_hit), reps)
    bnd = intersect_bound(packed, o.shape[0], visits, kind)
    log(f"[{name}] {packed.num_clusters} clusters: kernel {ms:.4f} ms/trace, "
        f"plain {plain_ms:.4f} ms/trace, {visits} (ray, cluster) visits, "
        f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    return k, (err, ms, plain_ms, *bnd)


def _record(results, kind, key, err, *times):
    res = results.setdefault(kind, dict(max_abs_err=0.0, times={}))
    res["max_abs_err"] = max(res["max_abs_err"], err)
    res["times"][key] = times


def _finish_times(res):
    """The kernels line's numbers of a kernel: contest closest hit on the
    unsorted rays, and `sorted_ms` on the sorted ones where timed."""
    res["ms"], res["plain_ms"], res["bound_ms"], res["bound_by"] = \
        res["times"]["contest_closest_unsorted"]
    if "contest_closest_sorted" in res["times"]:
        res["sorted_ms"] = res["times"]["contest_closest_sorted"][0]
    res["library_ms"] = None


def phase_intersect(dev, results):
    """Kernel 1 against its plain version, closest and any hit, on the
    gallery and contest frame 0, on the test rays unsorted and sorted."""
    from henjou_torch.accel import pallas_binned as pb
    from henjou_torch.runtime.renderer import Renderer
    from henjou_torch.tools.time_intersectors import ray_orders, test_rays

    rng = np.random.default_rng(2)
    for label, path in (("gallery", GALLERY), ("contest", CONTEST)):
        r = Renderer(device=dev)
        r.load_render_option(path)
        r._load_scene_from_option()
        fs, accel, cam = r.frame_scene(0)
        log(f"[intersect {label}] {accel.num_clusters} clusters, group {accel.group}")
        orders = ray_orders(accel, *test_rays(r, accel, cam, dev, rng))
        _both_orders(results, "binned", label, pb, pb.intersect_binned,
                     pb.intersect_binned_plain, accel, fs.tri_verts, orders, 20)
    _finish_times(results["binned"])


def _both_orders(results, kind, label, mod, fn, plain, packed, tri_verts, orders, reps):
    """`_trace_vs_plain` of a walk kernel on the rays as drawn and sorted,
    closest and any hit, each sorted result also held against the drawn
    one (`_same_back`)."""
    drawn = {}
    for order, (o, d, src) in orders.items():
        for any_hit in (False, True):
            hit = "any" if any_hit else "closest"
            k, out = _trace_vs_plain(f"{kind} {label} {hit} {order}", mod, kind, fn, plain,
                                     packed, tri_verts, o, d, any_hit, reps)
            if order == "unsorted":
                drawn[hit] = k
            else:
                _same_back(f"{kind} {label} {hit}", drawn[hit], k, src)
            _record(results, kind, f"{label}_{hit}_{order}", *out)
    log(f"[{kind} {label}] the sorted rays' results, put back, equal the drawn rays'")


def _cluster_kernel(kind):
    """(module, kernel wrapper, plain version, make_intersector, pack
    builder over a FrameScene) of a cluster intersector."""
    from henjou_torch.accel import pallas_cluster as pc
    from henjou_torch.accel import pallas_cluster_hbm as hbm
    from henjou_torch.accel import pallas_mxu as mxu

    return {
        "cluster": (pc, pc.intersect_pallas, pc.intersect_pallas_plain,
                    pc.make_pallas_intersector, lambda fs: pc.pack_clusters(fs.tri_verts)),
        "cluster_hbm": (hbm, hbm.intersect_pallas_hbm, hbm.intersect_pallas_hbm_plain,
                        hbm.make_pallas_hbm_intersector,
                        lambda fs: hbm.pack_clusters_hbm_np(fs.tri_verts.cpu().numpy(), fs.tri_verts.device)),
        "mxu": (mxu, mxu.intersect_pallas_mxu, mxu.intersect_pallas_mxu_plain,
                mxu.make_pallas_mxu_intersector,
                lambda fs: mxu.pack_clusters_mxu_np(fs.tri_verts.cpu().numpy(), fs.tri_verts.device)),
    }[kind]


def phase_cluster_intersect(dev, results):
    """Kernels 3-5 against their plain versions, closest and any hit, on
    the gallery and contest frame 0, on the test rays unsorted and sorted
    (phase 4's rays and checks)."""
    from henjou_torch.runtime.renderer import Renderer
    from henjou_torch.tools.time_intersectors import ray_orders, test_rays

    rng = np.random.default_rng(3)
    for label, path in (("gallery", GALLERY), ("contest", CONTEST)):
        r = Renderer(device=dev)
        r.load_render_option(path)
        r._load_scene_from_option()
        fs, accel, cam = r.frame_scene(0)
        orders = ray_orders(accel, *test_rays(r, accel, cam, dev, rng))
        for kind in CLUSTER_KERNELS:
            mod, fn, plain, _, build = _cluster_kernel(kind)
            t0 = time.monotonic()
            packed = build(fs)
            torch.cuda.synchronize()
            log(f"[{kind} {label}] pack {time.monotonic() - t0:.2f} s")
            _both_orders(results, kind, label, mod, fn, plain, packed, fs.tri_verts, orders, 10)
    for kind in CLUSTER_KERNELS:
        _finish_times(results[kind])


def _engine_vs_plain(tag, r, fs, accel, cam, w, h, spp, pool=False, **kw):
    """`wavefront_render` of r's frame at w x h, `spp`, 4096 lanes, one-sample
    MIS with r's sampler, once with the kernels and once with their plain
    versions passed explicitly: the binned kernel inside the bitonic sorted
    wrapper, or with `pool` the raw kernel with the whole pool sorted after
    every bounce by `bitonic_sort` (27 columns). Per-pixel RMSE of the mean
    colour at most TOL_ENGINE_RMSE, sample counts equal; `kw` goes to both
    calls. Returns the kernels' film."""
    from henjou_torch.accel import bitonic
    from henjou_torch.accel.pallas_binned import intersect_binned_plain, make_binned_intersector
    from henjou_torch.accel.sorting import make_bitonic_sorted_intersector, ray_sort_key
    from henjou_torch.integrator.wavefront import wavefront_render

    lo, hi = accel.scene_lo, accel.scene_hi
    kernel, plain = (make_binned_intersector(accel),
                     make_binned_intersector(accel, intersect=intersect_binned_plain))
    if pool:
        inv_extent = 1.0 / torch.clamp(hi - lo, min=1e-12)
        key = functools.partial(ray_sort_key, lo=lo, inv_extent=inv_extent)
        runs = [(kernel, dict(pool_key_fn=key, pool_sort=bitonic.bitonic_sort)),
                (plain, dict(pool_key_fn=key, pool_sort=bitonic.bitonic_sort_plain))]
    else:
        runs = [(make_bitonic_sorted_intersector(*kernel, lo, hi), {}),
                (make_bitonic_sorted_intersector(*plain, lo, hi, sort=bitonic.bitonic_sort_plain,
                                                 unsort=bitonic.bitonic_unsort_plain), {})]
    films = []
    for (ifn, ofn), extra in runs:
        t0 = time.monotonic()
        film = wavefront_render(
            fs, r.sky, cam, w, h, spp, r.bsdf_sample, bsdf_eval=r.bsdf_eval,
            bsdf_pdf=r.bsdf_pdf, integrator="mis", seed=r._frame_seed(0), lanes=4096,
            intersect_fn=ifn, occluded_fn=ofn, mis_single=True, sobol=r._sobol(), **extra, **kw,
        )
        torch.cuda.synchronize()
        films.append(film)
        log(f"{tag} {w}x{h} {spp} spp: {time.monotonic() - t0:.3f} s, "
            f"{int(film.n_traces)} traces")
    a, b = (f.color / f.count.clamp(min=1)[:, None] for f in films)
    rmse = float(torch.sqrt(((a - b) ** 2).mean()))
    if not torch.isfinite(a).all():
        raise AssertionError(f"{tag} kernel film not finite")
    if not torch.equal(films[0].count, films[1].count):
        raise AssertionError(f"{tag} sample counts differ")
    if rmse > TOL_ENGINE_RMSE:
        raise AssertionError(f"{tag} RMSE {rmse} > {TOL_ENGINE_RMSE}")
    log(f"{tag} kernels vs plain versions: RMSE {rmse:.3g} (mean {float(a.mean()):.4f}), "
        "counts equal")
    return films[0]


def _renderer(dev, path, **over):
    from henjou_torch.runtime.renderer import Renderer

    r = Renderer(device=dev)
    r.load_render_option(path)
    r.option = dataclasses.replace(r.option, **over)
    r._load_scene_from_option()
    return r


def phase_engine(dev):
    r = _renderer(dev, GALLERY)
    fs, accel, cam = r.frame_scene(0)
    _engine_vs_plain("[engine]", r, fs, accel, cam, 64, 36, 4)


def phase_engine_ref(dev):
    """Two-sample MIS on the gallery with each cluster kernel inside the
    argsort wrapper, against the same render with its plain version.
    Returns the kernels' launch counts of the kernel renders."""
    from henjou_torch.accel.sorting import make_sorted_intersector
    from henjou_torch.integrator.wavefront import wavefront_render
    from henjou_torch.runtime.renderer import Renderer

    r = Renderer(device=dev)
    r.load_render_option(GALLERY)
    r._load_scene_from_option()
    fs, accel, cam = r.frame_scene(0)
    w, h, spp = 64, 36, 4
    launches = {}
    for kind in CLUSTER_KERNELS:
        mod, fn, plain, make, build = _cluster_kernel(kind)
        packed = build(fs)
        films = []
        for intersect in (fn, plain):
            fns = make_sorted_intersector(*make(packed, intersect=intersect),
                                          accel.scene_lo, accel.scene_hi)
            if intersect is fn:
                for m in CLUSTER_KERNELS:
                    _cluster_kernel(m)[0].LAUNCHES = 0
            t0 = time.monotonic()
            film = wavefront_render(
                fs, r.sky, cam, w, h, spp, r.bsdf_sample, bsdf_eval=r.bsdf_eval,
                bsdf_pdf=r.bsdf_pdf, integrator="mis", seed=0, lanes=4096,
                intersect_fn=fns[0], occluded_fn=fns[1], mis_single=False,
            )
            torch.cuda.synchronize()
            if intersect is fn:
                launches[kind] = mod.LAUNCHES
                if launches[kind] == 0:
                    raise AssertionError(f"[engine ref] {kind}: the kernel was not launched")
            films.append(film)
            log(f"[engine ref] {kind} {'kernel' if intersect is fn else 'plain'} {w}x{h} "
                f"{spp} spp: {time.monotonic() - t0:.3f} s, {int(film.n_traces)} traces")
        a, b = (f.color / f.count.clamp(min=1)[:, None] for f in films)
        rmse = float(torch.sqrt(((a - b) ** 2).mean()))
        if not torch.isfinite(a).all():
            raise AssertionError(f"[engine ref] {kind}: kernel film not finite")
        if not torch.equal(films[0].count, films[1].count):
            raise AssertionError(f"[engine ref] {kind}: sample counts differ")
        if rmse > TOL_ENGINE_RMSE:
            raise AssertionError(f"[engine ref] {kind}: RMSE {rmse} > {TOL_ENGINE_RMSE}")
        log(f"[engine ref] {kind} kernel vs plain: RMSE {rmse:.3g} (mean {float(a.mean()):.4f}), "
            f"counts equal, {launches[kind]} launches")
    return launches


def _panel_lights_scene(n_panels=550):
    """A floor and n_panels emissive quads: 1,100 emissive triangles."""
    from henjou_torch.scene.scenedata import SceneData, make_material

    rng = np.random.default_rng(2)
    s, w = 10.0, 0.15
    verts = [[[-s, -1, -s], [-s, -1, s], [s, -1, s], [-s, -1, -s], [s, -1, s], [s, -1, -s]]]
    norms = [[[0, 1, 0]] * 6]
    for _ in range(n_panels):
        c = rng.uniform(-8, 8, 3)
        c[1] = rng.uniform(1.0, 6.0)
        x0, x1, y, z0, z1 = c[0] - w, c[0] + w, c[1], c[2] - w, c[2] + w
        verts.append([[x0, y, z0], [x1, y, z0], [x1, y, z1], [x0, y, z0], [x1, y, z1], [x0, y, z1]])
        norms.append([[0, -1, 0]] * 6)
    v = np.asarray(verts, np.float32).reshape(-1, 3)
    return SceneData(
        vertices=v, indices=np.arange(len(v), dtype=np.uint32),
        material_ids=np.repeat(np.asarray([0] + [1] * n_panels, np.uint32), 2),
        normals=np.asarray(norms, np.float32).reshape(-1, 3), texcoords=None, colors=None,
        materials=[make_material("floor", base_color=(0.7, 0.7, 0.7), roughness=0.8),
                   make_material("light", emission=(5.0, 4.0, 3.0), is_light=True)],
    )


def phase_light_query(dev):
    """The binned light query (kernel 1 on the emissive subset) against
    the dense `intersect_lights`."""
    from henjou_torch.accel import pallas_binned
    from henjou_torch.runtime.renderer import Renderer
    from henjou_torch.sampling.light_sample import (
        build_light_accel,
        intersect_lights,
        make_binned_light_intersector,
    )
    from henjou_torch.scene.scenedata import build_device_scene, build_frame_scene
    from henjou_torch.tools.time_intersectors import test_rays

    r = Renderer(device=dev)
    r.load_render_option(GALLERY)
    r._load_scene_from_option()
    fs, accel, cam = r.frame_scene(0)
    o, d = test_rays(r, accel, cam, dev, np.random.default_rng(4))
    fs_many = build_frame_scene(build_device_scene(_panel_lights_scene(), dev))
    rng = np.random.default_rng(5)
    o_m = rng.uniform(-9, 9, (N_RAYS, 3)).astype(np.float32)
    o_m[:, 1] = -0.5
    d_m = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d_m[:, 1] = np.abs(d_m[:, 1]) + 0.2  # up at the panels
    d_m /= np.linalg.norm(d_m, axis=1, keepdims=True)
    cases = (("gallery", fs, o, d),
             ("1100 lights", fs_many, torch.from_numpy(o_m).to(dev), torch.from_numpy(d_m).to(dev)))
    for label, frame, ro, rd in cases:
        la = build_light_accel(frame.tri_verts.cpu().numpy(),
                               frame.device.light_prim_ids.cpu().numpy(), dev)
        before = pallas_binned.LAUNCHES
        b = make_binned_light_intersector(la)(frame, ro, rd, 1e-3, 1e16)
        torch.cuda.synchronize()
        if pallas_binned.LAUNCHES != before + 1:
            raise AssertionError(f"[light query] {label}: the binned kernel was not launched")
        dn = intersect_lights(frame, ro, rd, 1e-3, 1e16)
        flips = int((b[4] != dn[4]).sum())
        if flips > TOL_FLIPS * ro.shape[0]:
            raise AssertionError(f"[light query] {label}: {flips} hit flips")
        both = b[4] & dn[4]
        rel = float(((b[0][both] - dn[0][both]).abs() / dn[0][both]).max()) if both.any() else 0.0
        if rel > TOL_T_REL_FORMULAS:
            raise AssertionError(f"[light query] {label}: t differs by a relative {rel}")
        same = both & (b[1] == dn[1])
        n_tie = int((both & ~same).sum())
        if n_tie > TOL_FLIPS * ro.shape[0]:
            raise AssertionError(f"[light query] {label}: prim differs on {n_tie} rays")
        area = float(((b[5][same] - dn[5][same]).abs() / dn[5][same]).max()) if same.any() else 0.0
        if area > 1e-5:
            raise AssertionError(f"[light query] {label}: area differs by a relative {area}")
        log(f"[light query] {label}: {la.light_prim_ids.numel()} lights in "
            f"{la.bc.num_clusters} clusters, hits {int(dn[4].sum())}/{ro.shape[0]}, flips {flips}, "
            f"max rel t err {rel:.3g}, prim ties {n_tie}, max rel area err {area:.3g}")


def _decode_png(path, w, h):
    from henjou_torch.post.png import read_png

    img = read_png(path)
    if img.shape[:2] != (h, w):
        raise AssertionError(f"{path}: {img.shape} is not {h}x{w}")


def phase_gallery(tmp):
    from henjou_torch import render

    stats_path = os.path.join(tmp, "gallery_stats.json")
    out = os.path.join(tmp, "gallery")
    t0 = time.monotonic()
    rc = render.main([GALLERY, "--spp", "16", "--out", out, "--stats", stats_path])
    wall = time.monotonic() - t0
    if rc != 0:
        raise AssertionError(f"render.main returned {rc}")
    _decode_png(out + "_000.png", 512, 288)
    with open(stats_path) as f:
        stats = json.load(f)
    fr = stats["frames"][0]
    if not fr["film_finite"]:
        raise AssertionError("[gallery] film not finite")
    if "canary_rmse" not in stats["setup"]:
        raise AssertionError("[gallery] the hardware canary did not run")
    log(f"[canary] per-pixel RMSE {stats['setup']['canary_rmse']:.3g} against the pinned film "
        f"(tolerance 5e-3), {stats['setup']['canary_s']:.2f} s")
    log(f"[gallery] 512x288 {fr['spp']} spp: render {fr['render_s']:.3f} s, "
        f"{fr['spp'] / fr['render_s']:.3f} spp/s, {fr['n_traces']} traces, "
        f"{fr['n_traces'] / fr['render_s'] / 1e6:.3f} Mrays/s; CLI wall {wall:.2f} s")


def phase_contest(dev, tmp, mis_mode="single", engine="auto"):
    """Phase 10 (the option file as shipped, two frames), with
    ``mis_mode="ref"`` phase 12 (frame 0 in Default mode), or with
    ``engine="masked"`` phase 18 (the option file with only its engine set
    to the masked one, two frames, 1 spp each: the masked film has no variance,
    so frame 1 takes DenoiseTemporal's blend-only branch). Returns frame
    0's AOVs."""
    from henjou_torch.accel import pallas_binned
    from henjou_torch.runtime.options import RenderMode
    from henjou_torch.runtime.renderer import Renderer

    shipped = mis_mode == "single"
    masked = engine == "masked"
    t0 = time.monotonic()
    r = Renderer(device=dev)
    r.load_render_option(CONTEST)
    over = dict(max_spp=4, mis_mode=mis_mode,
                image_name=os.path.join(tmp, f"contest_{engine}_{mis_mode}"))
    if masked:
        # 1 spp a frame keeps the script near 5 min
        over.update(engine="masked", max_spp=1)
    if not shipped:
        # 2 spp keeps the script inside ~5 min
        over.update(render_mode=RenderMode.DEFAULT, end_frame=1, max_spp=2)
    r.option = dataclasses.replace(r.option, **over)
    if shipped and (r.option.render_mode != RenderMode.DENOISE_TEMPORAL
                    or r.option.end_frame - r.option.start_frame != 2):
        raise AssertionError(f"[contest] {CONTEST} is not DenoiseTemporal over two frames")
    r._load_scene_from_option()
    finalize = r._finalize
    seen = []

    def counted(aovs, frame=None):
        # the binned launches of the finalize (the temporal depth probe)
        before = pallas_binned.LAUNCHES
        out = finalize(aovs, frame=frame)
        seen.append((aovs, pallas_binned.LAUNCHES - before, np.isfinite(out).all()))
        return out

    r._finalize = counted
    written = r.initialize_and_render()
    wall = time.monotonic() - t0
    if len(written) != len(seen):
        raise AssertionError(f"[contest] {len(written)} PNGs for {len(seen)} frames")
    for path in written:
        _decode_png(path, 1280, 720)
    s = r.setup_stats
    tag = f"[contest {engine} mis_mode={mis_mode}]"
    log(f"{tag} {r.option.render_mode.value}, {len(written)} frame(s) "
        f"{r.option.image_width}x{r.option.image_height}: wall {wall:.2f} s; "
        f"load {s['load_s']:.2f} s, "
        f"device scene {s['device_scene_s']:.2f} s")
    for fr, (_, probe_launches, image_finite) in zip(r.frame_stats, seen):
        if not fr["film_finite"] or not image_finite:
            raise AssertionError(f"[contest] frame {fr['frame']}: film or image not finite")
        if shipped and probe_launches == 0:
            raise AssertionError(f"[contest] frame {fr['frame']}: no binned launch in _finalize")
        log(f"{tag} frame {fr['frame']}: {fr['spp']} spp, "
            f"flatten+pack {fr['build_s']:.2f} s, render {fr['render_s']:.2f} s "
            f"({fr['spp'] / fr['render_s']:.3f} spp/s, "
            f"{fr['n_traces'] / fr['render_s'] / 1e6:.3f} Mrays/s), "
            f"finalize {fr['finalize_s']:.3f} s ({probe_launches} binned launches), "
            f"PNG {fr['finalize_png_s'] - fr['finalize_s']:.3f} s, total {fr['total_s']:.2f} s")
    if masked:
        if "variance" in seen[0][0] or r._temporal_raw is not None or r._temporal_prev_frame != 1:
            raise AssertionError("[contest masked] frame 1 did not take the blend-only branch")
        if [fr["spp"] for fr in r.frame_stats] != [1, 1]:
            raise AssertionError(f"[contest masked] spp {[fr['spp'] for fr in r.frame_stats]}")
    elif shipped and (r._temporal_raw is None or r._temporal_prev_frame != 1
                      or not float(r._temporal_raw[2].max()) > float(seen[1][0]["count"].max())):
        raise AssertionError("[contest] frame 1 did not merge frame 0's history")
    return seen[0][0]


def phase_gallery_modes(tmp):
    """Phase 14: the gallery through the CLI in the other render modes."""
    from henjou_torch import render

    with open(GALLERY) as f:
        doc = json.load(f)
    for mode in ("Denoise", "DenoiseUpScale2X", "Debug"):
        doc["Render_mode"] = mode
        path = os.path.join(tmp, f"gallery_{mode}.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        out = os.path.join(tmp, f"gallery_{mode}")
        stats_path = out + "_stats.json"
        t0 = time.monotonic()
        if render.main([path, "--spp", "4", "--out", out, "--stats", stats_path]) != 0:
            raise AssertionError(f"[gallery {mode}] render.main failed")
        wall = time.monotonic() - t0
        w, h = GALLERY_SIZE
        if mode == "Debug":
            for key in ("position", "basecolor", "normal", "texcoord"):
                _decode_png(f"{out}_{key}_000.png", w, h)
            log(f"[gallery {mode}] four {w}x{h} AOV PNGs; CLI wall {wall:.2f} s")
            continue
        _decode_png(out + "_000.png", w, h)
        with open(stats_path) as f:
            fr = json.load(f)["frames"][0]
        film = [h // 2, w // 2] if mode == "DenoiseUpScale2X" else [h, w]
        if fr["film_shape"] != film or not (fr["film_finite"] and fr["image_finite"]):
            raise AssertionError(f"[gallery {mode}] film {fr['film_shape']}, finite "
                                 f"{fr['film_finite']}, image finite {fr['image_finite']}")
        log(f"[gallery {mode}] film {film[1]}x{film[0]} -> {w}x{h} PNG, {fr['spp']} spp: render "
            f"{fr['render_s']:.3f} s, finalize {fr['finalize_s']:.3f} s; CLI wall {wall:.2f} s")


def phase_denoiser(dev, aovs):
    """Phase 15: the denoiser's functions on CUDA against the CPU on
    contest frame 0's AOVs; ms per call by CUDA events."""
    from henjou_torch.post import denoise as dn

    h, w = aovs["color"].shape[:2]
    iy, ix = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    arrays = dict(color=aovs["color"], albedo=aovs["albedo"], normal=aovs["normal"],
                  variance=aovs["variance"], count=aovs["count"].astype(np.float32),
                  # a known reprojection, fractional parts 0.8 and 0.9
                  px=ix + 0.5 + 1.3, py=iy + 0.5 - 0.6, valid=np.ones((h, w), bool))

    def calls(x):
        c, a, n = x["color"], x["albedo"], x["normal"]
        return {
            "denoise_atrous_var": (dn.denoise_atrous_var, (c, a, n, x["variance"])),
            "temporal_accumulate": (dn.temporal_accumulate,
                                    (c, x["variance"], x["count"], a, n, c, x["variance"],
                                     x["count"], a, n, x["px"], x["py"], x["valid"])),
            "denoise_temporal_reprojected": (dn.denoise_temporal_reprojected,
                                             (c, a, n, c, a, n, x["px"], x["py"], x["valid"])),
            "upscale2x_guided": (dn.upscale2x_guided,
                                 (c[::2, ::2], a[::2, ::2], n[::2, ::2], a, n)),
            "upscale2x": (dn.upscale2x, (c[::2, ::2],)),
        }

    on = {d: calls({k: torch.from_numpy(np.ascontiguousarray(v)).to(d) for k, v in arrays.items()})
          for d in ("cpu", dev)}
    for name, (fn, args) in on[dev].items():
        got = fn(*args)
        t0 = time.monotonic()
        want = on["cpu"][name][0](*on["cpu"][name][1])
        cpu_s = time.monotonic() - t0
        got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
        worst = 0.0
        for g, c in zip(got, want):
            g = g.cpu()
            if not torch.allclose(g, c, rtol=1e-4, atol=1e-5):
                raise AssertionError(f"[denoiser] {name}: CUDA differs from the CPU by "
                                     f"{float((g - c).abs().max())}")
            worst = max(worst, float((g - c).abs().max()))
        ms = cuda_ms(lambda: fn(*args), 5)
        log(f"[denoiser] {name} {w}x{h}: CUDA {ms:.3f} ms per call (events), CPU {cpu_s:.3f} s, "
            f"max abs diff {worst:.3g}")


def phase_scale(dev):
    from henjou_torch.tools.scale_test import ROWS, run_scale_test

    t0 = time.monotonic()
    # 1 spp per row (the tool's default is 2) keeps the script inside ~5 min
    out = run_scale_test(dev, spp=1, log=log)
    for name in ROWS:
        row = out["rows"][name]
        if not row["film_finite"]:
            raise AssertionError(f"[scale] {name}: film not finite")
        if min(row["launches"].values()) <= 0:
            raise AssertionError(f"[scale] {name}: a kernel was not launched: {row['launches']}")
    log(f"[scale] both rows in {time.monotonic() - t0:.2f} s")
    return out


def phase_obj(tmp):
    """Phase 16: the OBJ option file as shipped through the CLI; then the C
    HDR decode against the Python loop on the contest's sky."""
    from henjou_torch import native, render
    from henjou_torch.post.png import read_png
    from henjou_torch.texture.hdr import decode_rgbe_plain

    out = os.path.join(tmp, "cornell_obj")
    stats_path = out + "_stats.json"
    t0 = time.monotonic()
    if render.main([OBJ, "--out", out, "--stats", stats_path]) != 0:
        raise AssertionError("[obj] render.main failed")
    wall = time.monotonic() - t0
    img = read_png(out + "_000.png")
    if img.shape[:2] != (256, 256):
        raise AssertionError(f"[obj] PNG {img.shape}")
    # the ceiling light, seen from below at the top centre, saturates
    if int(img[:64, 96:160].max()) < 250:
        raise AssertionError(f"[obj] the light patch is not bright: {int(img[:64, 96:160].max())}")
    with open(stats_path) as f:
        stats = json.load(f)
    fr, su = stats["frames"][0], stats["setup"]
    if not fr["film_finite"]:
        raise AssertionError("[obj] film not finite")
    log(f"[obj] {OBJ} as shipped: {fr['film_shape'][1]}x{fr['film_shape'][0]}, {fr['spp']} spp "
        f"in {fr['render_s']:.3f} s ({fr['spp'] / fr['render_s']:.3f} spp/s, "
        f"{fr['n_traces'] / fr['render_s'] / 1e6:.3f} Mrays/s); set-up: canary "
        f"{su['canary_s']:.2f} s, load {su['load_s']:.3f} s, device scene "
        f"{su['device_scene_s']:.3f} s; light patch max {int(img[:64, 96:160].max())}; "
        f"CLI wall {wall:.2f} s")
    data = open("scenes/rtcamp_sky.hdr", "rb").read()
    head = data.index(b"\n\n") + 2
    eol = data.index(b"\n", head)
    _, h, _, w = data[head:eol].split()
    scan, w, h = data[eol + 1:], int(w), int(h)
    t0 = time.perf_counter()
    got = native.hdr_decode(scan, w, h)
    c_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = decode_rgbe_plain(scan, w, h)
    py_ms = (time.perf_counter() - t0) * 1e3
    if got.tobytes() != want.tobytes():
        raise AssertionError("[native] the C HDR decode differs from the Python loop")
    log(f"[native] scenes/rtcamp_sky.hdr {w}x{h}: C {c_ms:.3f} ms, Python {py_ms:.3f} ms, "
        f"byte-equal ({native.library_path().name})")


def phase_masked_gallery(dev, zero, counts):
    """Phase 17: the gallery at 512x288 with the masked engine against the
    wavefront engine's two-sample form: MIS at 2 spp, pathtrace and nee at
    1. The same CMJ streams: per-pixel RMSE of the means at most
    TOL_MASKED_RMSE, trace counts equal. The launch counts are zeroed just
    before, and read just after, each masked render; both kernels must grow
    in every one. Returns their sum over the masked renders."""
    from henjou_torch.runtime.renderer import Renderer

    r = Renderer(device=dev)
    r.load_render_option(GALLERY)
    r._load_scene_from_option()
    launches = {}
    # the two engines draw the same streams, so more spp would not tighten
    # the comparison; few keep the script near 5 min
    for integrator, spp in (("mis", 2), ("pathtrace", 1), ("nee", 1)):
        out = {}
        for engine in ("masked", "wavefront"):
            r.option = dataclasses.replace(r.option, engine=engine, mis_mode="ref",
                                           integrator=integrator, max_spp=spp)
            r.integrator = integrator
            zero()
            out[engine] = r.render_frame(0)
            torch.cuda.synchronize()
            if engine == "masked":
                got = counts()
                if min(got.values()) == 0:
                    raise AssertionError(f"[masked gallery] {integrator}: a kernel was not "
                                         f"launched: {got}")
                launches = {k: launches.get(k, 0) + v for k, v in got.items()}
            o = out[engine]
            log(f"[masked gallery] {integrator} {engine}: {o['spp_done']} spp in "
                f"{o['render_s']:.3f} s, {o['spp_done'] / o['render_s']:.3f} spp/s, "
                f"{o['n_traces']} traces, {o['n_traces'] / o['render_s'] / 1e6:.3f} Mrays/s")
        a, b = out["masked"]["color"], out["wavefront"]["color"]
        rmse = float(np.sqrt(((a - b) ** 2).mean()))
        if not np.isfinite(a).all():
            raise AssertionError(f"[masked gallery] {integrator}: film not finite")
        if out["masked"]["n_traces"] != out["wavefront"]["n_traces"]:
            raise AssertionError(f"[masked gallery] {integrator}: traces "
                                 f"{out['masked']['n_traces']} != {out['wavefront']['n_traces']}")
        if rmse > TOL_MASKED_RMSE:
            raise AssertionError(f"[masked gallery] {integrator}: RMSE {rmse} > {TOL_MASKED_RMSE}")
        log(f"[masked gallery] {integrator}: masked vs wavefront ref RMSE {rmse:.3g} "
            f"(limit {TOL_MASKED_RMSE:g}; mean {float(a.mean()):.4f}), traces equal")
    return launches


def _row_scale(tv, order):
    """Each refreshed row value's scale, in float64 (tests/
    test_torch_anim_accel.py): |e1||e2| for the normal n, |n||v0| for d;
    g1 and g2 as |e2|/|n| and |e1|/|n| times the condition |e1||e2|/|n|,
    h as that times |v0|."""
    v = np.where((order >= 0)[:, None, None], tv[np.maximum(order, 0)], 0.0).astype(np.float64)
    e1, e2, v0 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], v[:, 0]
    norm = functools.partial(np.linalg.norm, axis=1)
    ln = np.maximum(norm(np.cross(e1, e2)), 1e-30)
    cond = norm(e1) * norm(e2) / ln
    s1, s2 = norm(e2) / ln * cond, norm(e1) / ln * cond
    return np.stack([norm(e1) * norm(e2)] * 3 + [ln * norm(v0)] + [s1] * 3 + [s1 * norm(v0)]
                    + [s2] * 3 + [s2 * norm(v0)], axis=1)


def phase_anim(dev, results, zero, counts):
    """Phase 19: the contest scene with a keyframed translation on its mesh
    instance, frames 0-2 at 1280x720, 1 spp, wavefront engine. The host
    pack runs at most once (frame 0), frame 1 plans the order and every
    later set refreshes on the device. Each refreshed pack against the same
    refresh by torch ops on the CPU (boxes equal, rows within ROW_ULPS ulps
    of their scale), the binned kernel on it against its plain version
    within phase 4's limits. The launch counts are zeroed just before the
    renders and read just after them; returns them."""
    from henjou_torch.accel import pallas_binned as pb
    from henjou_torch.runtime.options import RenderMode
    from henjou_torch.runtime.renderer import Renderer
    from henjou_torch.scene import animation
    from henjou_torch.tools.time_intersectors import test_rays

    r = Renderer(device=dev)
    r.load_render_option(CONTEST)
    r._load_scene_from_option()
    a = animation.static_animation()
    a.translation.keys = [0.0, 1.0]
    a.translation.values = [[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]]
    r.scene.animations.append(a)
    for inst in r.scene.instances:
        inst.animation_id = len(r.scene.animations) - 1
    r.option = dataclasses.replace(r.option, max_spp=1, render_mode=RenderMode.DEFAULT,
                                   engine="wavefront", end_frame=3)
    packs = []
    real_pack = pb.pack_binned_np

    def timed_pack(*args, **kw):
        t0 = time.monotonic()
        out = real_pack(*args, **kw)
        torch.cuda.synchronize()
        packs.append(time.monotonic() - t0)
        return out

    pb.pack_binned_np = timed_pack
    zero()
    try:
        for f in range(3):
            out = r.render_frame(f)
            if not np.isfinite(out["color"]).all():
                raise AssertionError(f"[anim] frame {f}: film not finite")
            log(f"[anim] frame {f}: {out['spp_done']} spp, flatten+accel {out['build_s']:.3f} s, "
                f"render {out['render_s']:.3f} s ({out['spp_done'] / out['render_s']:.3f} spp/s, "
                f"{out['n_traces'] / out['render_s'] / 1e6:.3f} Mrays/s)")
    finally:
        pb.pack_binned_np = real_pack
    launches = counts()
    plan = r.scene_accel.plan
    if len(packs) > 1 or plan is None:
        raise AssertionError(f"[anim] {len(packs)} host packs, plan {plan is not None}")
    order, c, group, g = plan
    order_np = order.cpu().numpy()
    rng = np.random.default_rng(6)
    for f in (1, 2):
        fs, accel, cam = r.frame_scene(f)
        want = pb.build_binned_from_order(fs.tri_verts.cpu(), order_np, c, group, g)
        for name in ("aabb", "gaabb", "scene_lo", "scene_hi"):
            if not torch.equal(getattr(accel, name).cpu(), getattr(want, name)):
                raise AssertionError(f"[anim] frame {f}: refreshed {name} differs from the CPU")
        k_rows = accel.rows.cpu().numpy().reshape(-1, 16, pb.K).transpose(0, 2, 1).reshape(-1, 16)
        w_rows = want.rows.numpy().reshape(-1, 16, pb.K).transpose(0, 2, 1).reshape(-1, 16)
        if not np.array_equal(k_rows[:, 12:].view(np.int32), w_rows[:, 12:].view(np.int32)):
            raise AssertionError(f"[anim] frame {f}: rows 12-15 differ from the CPU")
        scale = _row_scale(fs.tri_verts.cpu().numpy(), order_np) * np.finfo(np.float32).eps
        ulps = np.abs(k_rows[:, :12].astype(np.float64) - w_rows[:, :12]) / np.maximum(scale, 1e-300)
        if ulps.max() > ROW_ULPS:
            raise AssertionError(f"[anim] frame {f}: rows differ by {ulps.max():.3g} ulps of "
                                 f"their scale (limit {ROW_ULPS})")
        bit_equal = np.array_equal(k_rows.view(np.int32), w_rows.view(np.int32))
        log(f"[anim] frame {f}: refreshed pack vs CPU torch ops: boxes equal, rows "
            f"{'bit-equal' if bit_equal else f'within {ulps.max():.3g} ulps of their scale'}")
        o, d = test_rays(r, accel, cam, dev, rng)
        for any_hit in (False, True):
            _, res = _trace_vs_plain(f"binned refreshed frame {f} {'any' if any_hit else 'closest'}",
                                     pb, "binned", pb.intersect_binned, pb.intersect_binned_plain,
                                     accel, fs.tri_verts, o, d, any_hit, 5)
            _record(results, "binned", f"anim_{f}_{any_hit}", *res)
    refresh_ms = cuda_ms(lambda: pb.build_binned_from_order(fs.tri_verts, order, c, group, g), 10)
    offs = r.device_scene.prim_offsets.cpu().numpy()
    t0 = time.monotonic()
    pb.plan_binned_order(fs.tri_verts.cpu().numpy(),
                         list(zip(offs.tolist(), np.diff(np.append(offs, fs.tri_verts.shape[0])).tolist())))
    plan_s = time.monotonic() - t0
    log(f"[anim] {fs.tri_verts.shape[0]} triangles, {c} clusters (group {group}): device refresh "
        f"{refresh_ms:.3f} ms (CUDA events), host pack {packs[0]:.3f} s (frame 0), plan "
        f"{plan_s:.3f} s (once); launches in the renders {launches}")
    return launches


def _options_vs_default(tag, r, options, zero, counts):
    """Frame 0 of r's option file through `render_frame` as it stands, then
    under each of `options`, {name: (option overrides, environment)}, with
    the launch counts zeroed just before and read just after each; logs
    spp/s and Mrays/s of every render. Returns (default AOVs, {name:
    (AOVs, launches)})."""
    base = r.option
    out = {}
    for name, (over, env) in [("default", ({}, {}))] + list(options.items()):
        r.option = dataclasses.replace(base, **over)
        os.environ.update(env)
        zero()
        try:
            o = r.render_frame(0)
            torch.cuda.synchronize()
        finally:
            for k in env:
                os.environ.pop(k)
        out[name] = (o, counts())
        log(f"{tag} {name} {over | env}: {o['spp_done']} spp in {o['render_s']:.3f} s, "
            f"{o['spp_done'] / o['render_s']:.3f} spp/s, {o['n_traces']} traces, "
            f"{o['n_traces'] / o['render_s'] / 1e6:.3f} Mrays/s")
        if not np.isfinite(o["color"]).all():
            raise AssertionError(f"{tag} {name}: film not finite")
    r.option = base
    return out.pop("default")[0], out


def phase_sobol(dev, zero, counts):
    """Phase 20: Sobol draws on the card bit-equal to the CPU over 2^16
    tagged and untagged states; the gallery with sampler="sobol" through
    the kernels against the plain versions (64x36, 4 spp); the gallery at
    512x288, 4 spp, with and without it. Returns the Sobol render's
    launches."""
    from henjou_torch.sampling import cmj

    rng = np.random.default_rng(20)
    n = 1 << 16
    seed = rng.integers(0, 1 << 31, n) | np.where(np.arange(n) % 2 == 0, cmj.SOBOL_SEED_FLAG, 0)
    args = [torch.from_numpy(x) for x in (rng.integers(0, 4096, n),
                                          rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
                                              np.int64), seed)]
    on_cpu = cmj.make_cmj_state(*args, sobol=True)
    on_dev = cmj.make_cmj_state(*(a.to(dev) for a in args), sobol=True)
    for _ in range(3):
        want, on_cpu = cmj.cmj_2d(on_cpu)
        got, on_dev = cmj.cmj_2d(on_dev)
        if not torch.equal(got.cpu(), want):
            raise AssertionError("[sobol] draws on CUDA differ from the CPU")
    log(f"[sobol] {n} states x 3 draws: CUDA bit-equal to the CPU")
    r = _renderer(dev, GALLERY, sampler="sobol", max_spp=4)
    fs, accel, cam = r.frame_scene(0)
    _engine_vs_plain("[sobol]", r, fs, accel, cam, 64, 36, 4)
    r.option = dataclasses.replace(r.option, sampler="cmj")
    _, out = _options_vs_default("[sobol]", r, {"sobol": (dict(sampler="sobol"), {})}, zero,
                                 counts)
    return out["sobol"][1]


def phase_ris_adaptive(dev, zero, counts):
    """Phase 21: contest frame 0 (Default mode) with light_ris=8 and with
    adaptive counts through the kernels against the plain versions (32x18,
    2 spp: the plain binned walk over the contest's 1,991 clusters takes
    seconds a frame); then at 1280x720 through `render_frame`: the default
    at 1 spp, light_ris=8 at 1 spp, and adaptive=True over a 2-spp warm-up
    batch and a 1-spp batch by variance (every pixel sampled twice, the
    counts uneven and summing to at most the budget, less than one sample
    a pixel under it; one sample has no variance, so a 1-spp warm-up would
    allocate uniformly). Returns each option's launches."""
    from henjou_torch.runtime.options import RenderMode

    r = _renderer(dev, CONTEST, render_mode=RenderMode.DEFAULT, end_frame=1, max_spp=1,
                  spp_batch=1)
    fs, accel, cam = r.frame_scene(0)
    w, h = 32, 18
    _engine_vs_plain("[ris]", r, fs, accel, cam, w, h, 2, light_ris=8)
    p = torch.arange(w * h, device=dev)
    _engine_vs_plain("[adaptive]", r, fs, accel, cam, w, h, 2,
                     sample_counts=torch.where(p % w < w // 2, 3, 1), sample_base=p % 3)
    _, out = _options_vs_default("[ris, adaptive]", r, {
        "light_ris": (dict(light_ris=8), {}),
        "adaptive": (dict(adaptive=True, max_spp=3, spp_batch=2), {})}, zero, counts)
    n = r.option.image_width * r.option.image_height
    cnt = out["adaptive"][0]["count"]
    total, budget = float(cnt.sum()), 3 * n
    if not (cnt.min() >= 2 and cnt.max() > cnt.min() and budget - n < total <= budget):
        raise AssertionError(f"[adaptive] counts min {cnt.min()} max {cnt.max()} sum {total} "
                             f"against a budget of {budget}")
    log(f"[adaptive] counts over {n} pixels: min {cnt.min():.0f}, max {cnt.max():.0f}, "
        f"sum {total:.0f} of the budget {budget}")
    return out["light_ris"][1], out["adaptive"][1]


def phase_pool_sort(dev, zero, counts):
    """Phase 22: the gallery with HENJOU_POOL_SORT=1: the raw binned kernel
    with the pool sorted after every bounce (27 columns, so one network
    and one gather launch a sort) against the plain versions (64x36, 4 spp,
    4096 lanes); then at 512x288 (65,536 lanes), 4 spp, through
    `render_frame` against the per-trace sorted film: the same rays, so
    per-pixel RMSE at most TOL_POOL_RMSE and traces equal. Every bitonic
    launch of that render is a pool sort. Returns its launches."""
    r = _renderer(dev, GALLERY, max_spp=4)
    fs, accel, cam = r.frame_scene(0)
    _engine_vs_plain("[pool sort]", r, fs, accel, cam, 64, 36, 4, pool=True)
    base, out = _options_vs_default("[pool sort]", r, {"pool": ({}, {"HENJOU_POOL_SORT": "1"})},
                                    zero, counts)
    pooled, launches = out["pool"]
    rmse = float(np.sqrt(((base["color"] - pooled["color"]) ** 2).mean()))
    if rmse > TOL_POOL_RMSE or base["n_traces"] != pooled["n_traces"]:
        raise AssertionError(f"[pool sort] RMSE {rmse} (limit {TOL_POOL_RMSE}), traces "
                             f"{pooled['n_traces']} against {base['n_traces']}")
    log(f"[pool sort] against the per-trace sorted film: RMSE {rmse:.3g} (limit "
        f"{TOL_POOL_RMSE:g}), traces equal")
    return launches


SHARD_WORLD = 2
SHARD_SPP = 4
ADAPTIVE_SIZE = (64, 36)


def _adaptive_renderer(dev, out_dir):
    """Phase 23's adaptive frame: the gallery at ADAPTIVE_SIZE, SHARD_SPP
    spp in 1-spp batches, PNG and checkpoint under `out_dir`."""
    return _renderer(dev, GALLERY, max_spp=SHARD_SPP, spp_batch=1, adaptive=True,
                     image_width=ADAPTIVE_SIZE[0], image_height=ADAPTIVE_SIZE[1],
                     image_directory=out_dir, image_name="adaptive")


def _adaptive_frame(dev, out_dir):
    """`initialize_and_render` of the adaptive frame in the current group,
    the canary skipped (the main path runs it): (this process's spp, its
    np.savez calls on the checkpoint path, the film it rendered or
    None)."""
    r = _adaptive_renderer(dev, out_dir)
    films, saves = [], []
    render_frame, savez = r.render_frame, np.savez

    def recorded_render(*a, **kw):
        films.append(render_frame(*a, **kw))
        return films[-1]

    def recorded_savez(path, *a, **kw):
        if ".ckpt.npz" in str(path):
            saves.append(str(path))
        return savez(path, *a, **kw)

    r.render_frame, np.savez = recorded_render, recorded_savez
    os.environ["HENJOU_SKIP_CANARY"] = "1"
    try:
        r.initialize_and_render()
    finally:
        np.savez = savez
        os.environ.pop("HENJOU_SKIP_CANARY")
    return r.frame_stats[0]["spp"], len(saves), films[0] if films else None


def _shard_worker(rank, store, out_dir, device, size):
    """One of phase 23's processes: joins the gloo group and renders its
    share of the gallery's SHARD_SPP spp at `size` on `device`, then the
    adaptive frame through `initialize_and_render`; saves the film and
    its launch counts, and the adaptive frame's spp, checkpoint writes and
    film."""
    import torch.distributed as dist

    from henjou_torch.accel import bitonic, pallas_binned
    from henjou_torch.bsdf import dispatch
    from henjou_torch.sampling import cmj

    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=SHARD_WORLD,
                            rank=rank)
    try:
        dev = torch.device(device)
        r = _renderer(dev, GALLERY, max_spp=SHARD_SPP, spp_batch=1, image_width=size[0],
                      image_height=size[1])
        bitonic.LAUNCHES = pallas_binned.LAUNCHES = cmj.LAUNCHES = dispatch.LAUNCHES = 0
        out = r.render_frame(0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        launches = dict(bitonic=bitonic.LAUNCHES, binned=pallas_binned.LAUNCHES, cmj=cmj.LAUNCHES,
                        bsdf=dispatch.LAUNCHES)
        spp, saves, film = _adaptive_frame(dev, out_dir)
        adaptive = {} if film is None else dict(adaptive_color=film["color"],
                                                 adaptive_count=film["count"],
                                                 adaptive_traces=film["n_traces"])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), color=out["color"],
                 count=out["count"], traces=out["n_traces"], spp=out["spp_done"],
                 render_s=out["render_s"], adaptive_spp=spp, adaptive_saves=saves,
                 **launches, **adaptive)
    finally:
        dist.destroy_process_group()


def phase_sharded(dev, tmp, size=GALLERY_SIZE):
    """Phase 23: two processes in a gloo group on `dev` shard the gallery's
    spp (512x288, SHARD_SPP spp, spp_batch 1: process k takes sample k of
    every pair) against one process: per-pixel RMSE at most
    TOL_SHARD_RMSE, counts and traces equal. NCCL refuses two ranks on one
    card, so the film sums go through the CPU. Then, in the same
    processes, an adaptive frame (not sharded) through
    `initialize_and_render` with the checkpoint path both share: rank 1
    renders 0 spp and writes no checkpoint, rank 0 writes it once per
    batch, none is left after the frame, and rank 0's film equals one
    process's within TOL_SHARD_RMSE, counts and traces equal. Returns the
    sharded render's launches summed over both processes."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(tmp, "sharded")
    os.makedirs(out_dir)
    t0 = time.monotonic()
    mp.spawn(_shard_worker, args=(os.path.join(out_dir, "store"), out_dir, str(dev), size),
             nprocs=SHARD_WORLD)
    wall = time.monotonic() - t0
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{k}.npz"))) for k in range(SHARD_WORLD)]
    one = _renderer(dev, GALLERY, max_spp=SHARD_SPP, spp_batch=1, image_width=size[0],
                    image_height=size[1]).render_frame(0)
    for k, got in enumerate(ranks):
        rmse = float(np.sqrt(((got["color"] - one["color"]) ** 2).mean()))
        if (rmse > TOL_SHARD_RMSE or int(got["traces"]) != one["n_traces"]
                or not np.array_equal(got["count"], one["count"]) or int(got["spp"]) != SHARD_SPP):
            raise AssertionError(f"[sharded] rank {k}: RMSE {rmse} (limit {TOL_SHARD_RMSE}), "
                                 f"traces {int(got['traces'])} against {one['n_traces']}, "
                                 f"spp {int(got['spp'])}")
        log(f"[sharded] rank {k}: RMSE {rmse:.3g} against one process (limit "
            f"{TOL_SHARD_RMSE:g}), counts and traces equal; render {float(got['render_s']):.3f} s "
            f"({SHARD_SPP / float(got['render_s']):.3f} spp/s)")
    log(f"[sharded] one process: render {one['render_s']:.3f} s "
        f"({SHARD_SPP / one['render_s']:.3f} spp/s); two processes' wall {wall:.2f} s "
        "(process start included)")
    r0, r1 = ranks
    left = [f for f in os.listdir(out_dir) if f.endswith(".ckpt.npz")]
    if (int(r1["adaptive_spp"]) != 0 or int(r1["adaptive_saves"]) != 0
            or "adaptive_color" in r1 or int(r0["adaptive_saves"]) != SHARD_SPP or left):
        raise AssertionError(
            f"[sharded adaptive] rank 1: {int(r1['adaptive_spp'])} spp, "
            f"{int(r1['adaptive_saves'])} checkpoint writes; rank 0: "
            f"{int(r0['adaptive_saves'])} writes (want {SHARD_SPP}); left behind: {left}")
    want = _adaptive_renderer(dev, os.path.join(tmp, "adaptive_one")).render_frame(0)
    rmse = float(np.sqrt(((r0["adaptive_color"] - want["color"]) ** 2).mean()))
    if (rmse > TOL_SHARD_RMSE or not np.array_equal(r0["adaptive_count"], want["count"])
            or int(r0["adaptive_traces"]) != want["n_traces"]):
        raise AssertionError(f"[sharded adaptive] rank 0: RMSE {rmse} (limit {TOL_SHARD_RMSE}), "
                             f"traces {int(r0['adaptive_traces'])} against {want['n_traces']}")
    log(f"[sharded adaptive] {ADAPTIVE_SIZE[0]}x{ADAPTIVE_SIZE[1]}, {SHARD_SPP} spp: rank 0 "
        f"rendered it alone ({int(r0['adaptive_saves'])} checkpoint writes), rank 1 0 spp and "
        f"no writes, no checkpoint left; rank 0 against one process: RMSE {rmse:.3g}, counts "
        "and traces equal")
    return {k: int(sum(got[k] for got in ranks)) for k in ("bitonic", "binned", "cmj", "bsdf")}


API_LANES = 1 << 16
# sample_atlas on CUDA against the CPU: the same gathers and bilinear
# weights, which the two devices may round differently in the last ulp
TOL_ATLAS = 1e-6


def phase_api(dev, zero, counts):
    """Phase 24: the public API on the card. `cmj_3d` and `cmj_4d` on
    API_LANES states (Sobol tag on half) bit-equal to the CPU;
    `sample_atlas` on CUDA against the CPU within TOL_ATLAS, tex_id -1 on
    some lanes; `wavefront_pathtrace` on the gallery with its default
    intersector (a pack given: binned inside the bitonic sorted wrapper)
    against the plain versions passed explicitly (64x36, 4 spp, 4096
    lanes, phase 6's limits); then the kernels alone at 512x288, 4 spp,
    65,536 lanes, counted. Returns that render's launches."""
    from henjou_torch.accel import bitonic
    from henjou_torch.accel.pallas_binned import intersect_binned_plain, make_binned_intersector
    from henjou_torch.accel.sorting import make_bitonic_sorted_intersector
    from henjou_torch.integrator.wavefront import wavefront_pathtrace
    from henjou_torch.sampling import cmj_3d, cmj_4d, make_cmj_state
    from henjou_torch.sampling.cmj import SOBOL_SEED_FLAG
    from henjou_torch.texture.atlas import build_atlas, sample_atlas
    from henjou_torch.texture.texture import TexType, Texture

    rng = np.random.default_rng(24)
    n = API_LANES
    seed = rng.integers(0, 1 << 31, n) | np.where(np.arange(n) % 2 == 0, SOBOL_SEED_FLAG, 0)
    args = [torch.from_numpy(x) for x in (rng.integers(0, 4096, n),
                                          rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
                                              np.int64), seed)]
    for draw in (cmj_3d, cmj_4d):
        on_cpu = make_cmj_state(*args, sobol=True)
        on_dev = make_cmj_state(*(a.to(dev) for a in args), sobol=True)
        for _ in range(2):
            want, on_cpu = draw(on_cpu)
            got, on_dev = draw(on_dev)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"[api] {draw.__name__} on CUDA differs from the CPU")
    log(f"[api] cmj_3d, cmj_4d: {n} states x 2 draws, CUDA bit-equal to the CPU")
    texs = [Texture(name=f"t{k}", data=rng.uniform(0, 1, (h, w, 4)).astype(np.float32),
                    tex_type=TexType.NON_COLOR) for k, (h, w) in enumerate(((64, 48), (17, 130)))]
    tex_id = torch.from_numpy(rng.integers(-1, len(texs), n))
    u, v = (torch.from_numpy(rng.uniform(-2, 2, n).astype(np.float32)) for _ in range(2))
    want = sample_atlas(build_atlas(texs, "cpu"), tex_id, u, v)
    got = sample_atlas(build_atlas(texs, dev), tex_id.to(dev), u.to(dev), v.to(dev)).cpu()
    err = float((got - want).abs().max())
    if err > TOL_ATLAS:
        raise AssertionError(f"[api] sample_atlas on CUDA: max abs err {err} > {TOL_ATLAS}")
    log(f"[api] sample_atlas: {n} lanes, CUDA against the CPU max abs err {err:.3g}")

    r = _renderer(dev, GALLERY)
    fs, accel, cam = r.frame_scene(0)
    if accel is None:
        raise AssertionError("[api] the gallery has no binned pack")
    plain, _ = make_bitonic_sorted_intersector(
        *make_binned_intersector(accel, intersect=intersect_binned_plain), accel.scene_lo,
        accel.scene_hi, sort=bitonic.bitonic_sort_plain, unsort=bitonic.bitonic_unsort_plain)

    def render(w, h, lanes, **kw):
        t0 = time.monotonic()
        film = wavefront_pathtrace(fs, r.sky, cam, w, h, 4, r.bsdf_sample,
                                   seed=r._frame_seed(0), lanes=lanes, **kw)
        torch.cuda.synchronize()
        return film, time.monotonic() - t0

    films = [render(64, 36, 4096, accel=accel)[0], render(64, 36, 4096, intersect_fn=plain)[0]]
    a, b = (f.color / f.count.clamp(min=1)[:, None] for f in films)
    rmse = float(torch.sqrt(((a - b) ** 2).mean()))
    if not torch.isfinite(a).all() or not torch.equal(films[0].count, films[1].count):
        raise AssertionError("[api] wavefront_pathtrace: kernel film not finite or counts differ")
    if rmse > TOL_ENGINE_RMSE:
        raise AssertionError(f"[api] wavefront_pathtrace RMSE {rmse} > {TOL_ENGINE_RMSE}")
    log(f"[api] wavefront_pathtrace 64x36 4 spp: kernels vs plain versions RMSE {rmse:.3g} "
        f"(mean {float(a.mean()):.4f}), counts equal")
    w, h = GALLERY_SIZE
    zero()
    film, secs = render(w, h, 1 << 16, accel=accel)
    launches = counts()
    if not torch.isfinite(film.color).all() or int(film.count.min()) != 4:
        raise AssertionError("[api] wavefront_pathtrace at full size: film not finite or short")
    log(f"[api] wavefront_pathtrace {w}x{h} 4 spp, 65536 lanes: {secs:.3f} s, "
        f"{4 / secs:.3f} spp/s, {int(film.n_traces)} traces, "
        f"{int(film.n_traces) / secs / 1e6:.3f} Mrays/s; launches {launches}")
    return launches


CMJ_LANES = (1 << 17, 1280 * 720)
CMJ_STATE_BYTES = 4 * 8  # n_spp, scramble, depth, image_idx in


def phase_cmj(dev, results):
    """Phase 25: `cmj_2d` and `cmj_4d` through ``csrc/cmj.cu`` at each of
    CMJ_LANES on a state as the engines make it (`make_cmj_state`, depth
    advanced): values and depth bit-equal to the torch code on the same
    state; the draw per call by CUDA events and as a CUDA graph replay, the
    torch code by CUDA events, and the bound (the state read, the values
    and the new depth written, at 3.35 TB/s)."""
    from henjou_torch.sampling import cmj

    rng = np.random.default_rng(25)
    rows = {}
    for n in CMJ_LANES:
        spp = torch.from_numpy(rng.integers(0, 4096, n)).to(dev)
        pix = torch.from_numpy(rng.integers(0, n, n)).to(dev)
        st = cmj.make_cmj_state(spp, pix, int(rng.integers(0, 1 << 31)))
        st = st._replace(depth=torch.from_numpy(rng.integers(0, 40, n)).to(dev))
        for width, draw in ((2, cmj.cmj_2d), (4, cmj.cmj_4d)):
            got, got_st = draw(st)
            want, want_st = cmj.draw_plain(st, width)
            if not (torch.equal(got, want) and torch.equal(got_st.depth, want_st.depth)):
                raise AssertionError(f"[cmj] {draw.__name__} at {n} lanes differs from the torch code")
            ms = cuda_ms(lambda: draw(st), 200)
            g_ms = graph_ms(lambda: draw(st), 200)
            plain_ms = cuda_ms(lambda: cmj.draw_plain(st, width), 10)
            bound_ms, bound_by = bound(n * (CMJ_STATE_BYTES + 4 * width + 8))
            rows[f"{draw.__name__}@{n}"] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                                                 bound_ms=bound_ms, bound_by=bound_by)
            log(f"[cmj] {draw.__name__} {n} lanes: bit-equal to the torch code; kernel "
                f"{_fmt_ms(ms)} per call ({_fmt_ms(g_ms)} as a graph), torch code "
                f"{_fmt_ms(plain_ms)}, bound {_fmt_ms(bound_ms)} ({bound_by})")
    main = rows[f"cmj_2d@{CMJ_LANES[0]}"]
    results["cmj"] = dict(main, by_shape=rows)


BSDF_LANES = (1 << 16, 1 << 17)
# bytes a lane: the hit's fields, the directions and the state read; the
# outputs written (bsdf, wi, pdf, depth; the value; the pdf)
BSDF_LANE_BYTES = {"bsdf_sample": 78 + 36, "bsdf_eval": 54 + 12, "bsdf_pdf": 33 + 4}
BSDF_KERNELS = ("bsdf_sample", "bsdf_eval", "bsdf_pdf")


def bsdf_resources():
    """{kernel: registers and spill bytes} of csrc/bsdf.cu's three kernels,
    from its build with ``-Xptxas -v`` and the library's flags."""
    import re

    from henjou_torch import csrc

    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([csrc._nvcc(), *csrc.COMPILE_FLAGS, "-Xptxas", "-v", "-c", "-o",
                              os.path.join(tmp, "bsdf.o"), str(csrc.CSRC_DIR / "bsdf.cu")],
                             capture_output=True, text=True, check=True, timeout=900)
    res, name = {}, None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((k for k in BSDF_KERNELS if f"{k}_kernel" in m.group(1)), None)
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            res.setdefault(name, {}).update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            res.setdefault(name, {})["registers"] = int(m[1])
    if set(res) != set(BSDF_KERNELS):
        raise AssertionError(f"[bsdf] ptxas reported {sorted(res)}:\n{out.stderr}")
    return res


def _torch_launches(fn):
    """The launches of `fn()`: torch's non-view ops that are not allocations,
    and the CMJ kernel's draws."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from henjou_torch.sampling import cmj

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view and func.overloadpacket not in (torch.ops.aten.empty,
                                                                torch.ops.aten.empty_like):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    draws = cmj.LAUNCHES
    with Count():
        fn()
    return Count.n + cmj.LAUNCHES - draws


def _bsdf_inputs(dev, n, rng):
    """A hit of `n` lanes with the contest scene's lobes (meta-glass, metals,
    Disney, thin film), wo mostly above the surface, wi anywhere, and a
    state as the engines make it."""
    from henjou_torch.sampling import cmj

    hit = types.SimpleNamespace(
        basecolor=rng.uniform(0, 1, (n, 3)), roughness=rng.uniform(0, 1, n),
        metallic=np.where(rng.uniform(size=n) < 0.4, 1.0, rng.uniform(0, 0.5, n)),
        sheen=np.zeros(n), clearcoat=np.zeros(n), ior=rng.uniform(1.2, 2.0, n),
        is_thinfilm=rng.uniform(size=n) < 0.3, is_specular=rng.uniform(size=n) < 0.2)
    for k, v in vars(hit).items():
        setattr(hit, k, torch.from_numpy(v.astype(np.float32) if v.dtype.kind == "f" else v).to(dev))
    wo, wi = (rng.normal(size=(n, 3)) for _ in range(2))
    wo[:, 1] = np.where(rng.uniform(size=n) < 0.9, np.abs(wo[:, 1]), wo[:, 1])
    wo, wi = (torch.from_numpy((v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32))
              .to(dev) for v in (wo, wi))
    st = cmj.make_cmj_state(torch.from_numpy(rng.integers(0, 4096, n)).to(dev),
                            torch.from_numpy(rng.integers(0, 1280 * 720, n)).to(dev),
                            int(rng.integers(0, 1 << 31)))
    return hit, wo, wi, st._replace(depth=torch.from_numpy(rng.integers(0, 40, n)).to(dev))


def _same(a, b):
    nan = a.isnan()
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(nan, b.isnan())
            and torch.equal(a[~nan], b[~nan]))


def phase_bsdf(dev, results):
    """Phase 26: `bsdf_sample`, `bsdf_eval` and `bsdf_pdf` through
    ``csrc/bsdf.cu`` at each of BSDF_LANES with the contest scene's flags
    (glass, metal, the LUT; no sheen, no clearcoat): one launch a call, the
    values (and the sample's depth) bit-equal to the plain torch code on the
    same device; the kernel and the plain code each timed per call by CUDA
    events (the wrapper's host cost included) and as a CUDA graph replay
    (the device alone), the plain code's launches counted, the bound (the
    lanes' bytes at 3.35 TB/s); then the kernels' registers and spills."""
    from henjou_torch.bsdf import dispatch
    from henjou_torch.sampling import cmj
    from henjou_torch.texture.lut import default_lut

    rng = np.random.default_rng(26)
    lut = default_lut(dev)
    flags = dict(has_specular=True, has_metal=True, has_sheen=False, has_clearcoat=False)
    rows = {}
    for n in BSDF_LANES:
        hit, wo, wi, st = _bsdf_inputs(dev, n, rng)
        calls = {
            "bsdf_sample": (lambda: dispatch.bsdf_sample(hit, wo, st, lut, **flags),
                            lambda: dispatch.sample_plain(hit, wo, st, lut, **flags)),
            "bsdf_eval": (lambda: dispatch.bsdf_eval(hit, wo, wi, lut, False, False),
                          lambda: dispatch.eval_plain(hit, wo, wi, lut, False, False)),
            "bsdf_pdf": (lambda: dispatch.bsdf_pdf(hit, wo, wi),
                         lambda: dispatch.pdf_plain(hit, wo, wi)),
        }
        for name, (kernel, plain) in calls.items():
            launches, draws = dispatch.LAUNCHES, cmj.LAUNCHES
            got = kernel()
            if (dispatch.LAUNCHES, cmj.LAUNCHES) != (launches + 1, draws):
                raise AssertionError(f"[bsdf] {name}: not one launch of the kernel")
            want = plain()
            got, want = ((x[:3] + (x[3].depth,)) if isinstance(x, tuple) else (x,)
                         for x in (got, want))
            if not all(_same(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"[bsdf] {name} at {n} lanes differs from the torch code")
            ms, g_ms = cuda_ms(kernel, 200), graph_ms(kernel, 200)
            plain_ms, plain_g_ms = cuda_ms(plain, 5), graph_ms(plain, 5)
            bound_ms, bound_by = bound(n * BSDF_LANE_BYTES[name])
            rows[f"{name}@{n}"] = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
                                       plain_graph_ms=plain_g_ms,
                                       plain_launches=_torch_launches(plain),
                                       bound_ms=bound_ms, bound_by=bound_by)
            log(f"[bsdf] {name} {n} lanes: bit-equal to the torch code, 1 launch; kernel "
                f"{_fmt_ms(ms)} per call ({_fmt_ms(g_ms)} as a graph); torch code "
                f"{_fmt_ms(plain_ms)} ({_fmt_ms(plain_g_ms)} as a graph, "
                f"{rows[f'{name}@{n}']['plain_launches']} launches); bound "
                f"{_fmt_ms(bound_ms)} ({bound_by})")
    res = bsdf_resources()
    log(f"[bsdf] registers and spill bytes (stores, loads): " + ", ".join(
        f"{k} {v['registers']}, {v['spill_stores']}/{v['spill_loads']}" for k, v in res.items()))
    results["bsdf"] = dict(rows[f"bsdf_sample@{BSDF_LANES[1]}"], by_shape=rows, resources=res)


def _net_forms(bn, st, plain_st):
    """Each kernel of bitonic_net in every form its wrapper takes, against
    its plain version on the same [10, 65536] state: yields (kernel, form,
    kernel output, plain output)."""
    n = st.shape[1]
    subs = bn.substages(n)
    for k, j in ((32, 16), (1024, 512), (16, 16), (n, n // 2), (2, 1)):
        for per_plane in (False, True):
            for mode in bn.MODES:
                if mode == "static" and (k, j) not in bn.STATIC_PAIRS:
                    continue
                kw = dict(per_plane=per_plane, mode=mode)
                yield ("net_substage", f"({k},{j}) {kw}", bn.net_substage(st, k, j, **kw),
                       bn.net_substage_plain(plain_st, k, j, **kw))
    for guards in bn.GUARDS:
        kw = dict(mode="static", guards=guards, lj=0)
        yield ("net_substage", f"(32,16) {kw}", bn.net_substage(st, 32, 16, **kw),
               bn.net_substage_plain(plain_st, 32, 16, **kw))
    in_place = st.clone()
    bn.net_substage(in_place, 1024, 512, dst=in_place)
    yield ("net_substage", "(1024,512) in place", in_place,
           bn.net_substage_plain(plain_st, 1024, 512))
    for label, lst in (("136 x (32,16)", [(32, 16)] * 136),
                       ("k <= 1024", [kj for kj in subs if kj[0] <= 1024]),
                       ("k = 65536, j < 1024", [kj for kj in subs if kj[0] == n and kj[1] < 1024])):
        yield ("net_local", label, bn.net_local(st, lst), bn.net_local_plain(plain_st, lst))
    sched = bn.make_schedule(subs, n, st.device)
    for switch in (True, False):
        yield ("net_walk", f"switch={switch}", bn.net_walk(st, sched, switch=switch),
               bn.net_walk_plain(plain_st, sched))
        yield ("net_walk", f"in place, switch={switch}",
               bn.net_walk(st.clone(), sched, inplace=True, switch=switch),
               bn.net_walk_plain(plain_st, sched))
    for label, lst in (("55 substages", subs[:55]), ("k == j, mixed", bn.MIXED_SUBS)):
        odd = bn.make_schedule(lst, n, st.device)
        for inplace in (False, True):
            for switch in (False, True):
                yield ("net_walk", f"{label}, inplace={inplace}, switch={switch}",
                       bn.net_walk(st.clone() if inplace else st, odd, inplace=inplace,
                                   switch=switch),
                       bn.net_walk_plain(plain_st, odd))
    for per_plane in (False, True):
        yield ("roll_pass", f"per_plane={per_plane}", bn.roll_pass(st, per_plane=per_plane),
               bn.roll_pass_plain(plain_st))


def net_device_us(bn, rows):
    """{row label: {kernel: (launches, mean device us per launch)}} of the
    network kernels in each of `rows` [(label, call)], each call made
    once, in order, in one torch.profiler session (later sessions in one
    process lost kernel events on the card). The kernel events, sorted by
    start, are cut by each row's launch count from LAUNCHES; None when the
    profiler did not record them all."""
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _, fn in rows:  # the warm-up also counts each row's launches
        before = dict(bn.LAUNCHES)
        fn()
        counts.append(sum(bn.LAUNCHES[k] - before[k] for k in NET_KERNEL_NAMES))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _, fn in rows:
            fn()
        torch.cuda.synchronize()
    events = sorted(((e.time_range.start, kernel, e.time_range.elapsed_us())
                     for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     for kernel, names in NET_KERNEL_NAMES.items()
                     if any(name in e.name for name in names)),
                    key=lambda x: x[0])
    if len(events) != sum(counts):
        log(f"[net] torch.profiler recorded {len(events)} network kernels of {sum(counts)}")
        return None
    out, at = {}, 0
    for (label, _), count in zip(rows, counts):
        row = {}
        for _, kernel, us in events[at:at + count]:
            n, total = row.get(kernel, (0, 0.0))
            row[kernel] = (n + 1, total + us)
        out[label] = {k: (n, total / n) for k, (n, total) in row.items()}
        at += count
    return out


def phase_bitonic_net(dev, results):
    """13. Every row of the four bitonic-schedule tools, kernels against
    plain versions; the yardsticks beside the full-sort rows; each kernel
    alone. Returns the kernels' launch counts of the rows."""
    import importlib

    from henjou_torch.accel import bitonic
    from henjou_torch.accel import bitonic_net as bn
    from henjou_torch.tools.exp_bitonic import make_input
    from henjou_torch.tools.exp_bitonic2 import make_g_input
    from henjou_torch.tools.exp_bitonic2 import make_input as make_uniform_input

    tools = {name: importlib.import_module(f"henjou_torch.tools.{name}") for name in NET_TOOLS}
    t0 = time.monotonic()
    for k in bn.LAUNCHES:
        bn.LAUNCHES[k] = 0
    rows = {name: tool.run_all(dev, log=lambda line, name=name: log(f"[net {name}] {line}"))
            for name, tool in tools.items()}
    launches = dict(bn.LAUNCHES)
    if min(launches.values()) == 0:
        raise AssertionError(f"[net] a kernel was not launched by the rows: {launches}")
    log(f"[launches] bitonic network rows: {launches}")
    for name, tool in tools.items():
        plain = tool.run_all(dev, reps=2, plain=True,
                             log=lambda line, name=name: log(f"[net {name} plain] {line}"))
        for row, r in rows[name].items():
            if not torch.equal(r["out"], plain[row]["out"]):
                raise AssertionError(f"[net] {name} {row!r}: kernel differs from the plain version")
            if r["ok"] is False:
                raise AssertionError(f"[net] {name} {row!r}: keys not sorted")
    x5 = rows["exp_bitonic4"]["X5 dynamic j,k (dyn rolls)"]["out"][0]
    if not bool((x5[1:] >= x5[:-1]).all()):
        raise AssertionError("[net] exp_bitonic4 X5: keys not sorted")
    log(f"[net] every row of {len(NET_TOOLS)} tools bit-equal to its plain version on every plane")
    # the yardsticks on the inputs of the full-sort rows
    n = 1 << 16
    for label, inp in (("exp_bitonic 10-plane", make_input(n, 9)),
                       ("exp_bitonic 5-plane", make_input(n, 4)),
                       ("exp_bitonic2 G / exp_bitonic3", make_g_input()),
                       ("exp_bitonic4 X5", make_uniform_input())):
        st = torch.from_numpy(inp).to(dev)
        prod_ms = cuda_ms(lambda: bitonic.bitonic_sort(st[0], *st[1:]), 20)
        lib_ms = cuda_ms(lambda: argsort_gather(st[0], *st[1:]), 20)
        log(f"[net] yardsticks, {label} input ({st.shape[0]} planes): bitonic_sort (one "
            f"network launch) {prod_ms:.4f} ms, argsort+gather {lib_ms:.4f} ms")
    # each kernel alone, every form, at 65,536 x 10
    st = torch.from_numpy(make_uniform_input()).to(dev)
    plain_st = st.clone()
    worst = dict.fromkeys(bn.LAUNCHES, 0.0)
    for kernel, form, got, want in _net_forms(bn, st, plain_st):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[net] {kernel} {form}: kernel differs from the plain version")
        worst[kernel] = max(worst[kernel], float((got.long() - want.long()).abs().max()))
    log("[net] each kernel in every form bit-equal to its plain version at 65536 x 10")
    sched = bn.make_schedule(bn.substages(n), n, dev)
    c_list = [(32, 16)] * 136
    buf = torch.empty_like(st)
    timed = {
        "net_substage": (lambda: bn.net_substage(st, 32, 16, dst=buf, mode="static"),
                         lambda: bn.net_substage_plain(st, 32, 16, dst=buf, mode="static"),
                         None, "one stacked (32, 16) substage"),
        "net_local": (lambda: bn.net_local(st, c_list, dst=buf),
                      lambda: bn.net_local_plain(st, c_list, dst=buf),
                      None, "136 x (32, 16) on one tile layout (row C)"),
        "net_walk": (lambda: bn.net_walk(st, sched, switch=True),
                     lambda: bn.net_walk_plain(st, sched),
                     lambda: argsort_gather(st[0], *st[1:]),
                     f"the full sort, switch (136 substages in {len(sched.passes)} passes)"),
        "roll_pass": (lambda: bn.roll_pass(st, dst=buf), lambda: bn.roll_pass_plain(st, dst=buf),
                      None, "one stacked roll pass"),
    }
    state_bytes = 2 * st.numel() * st.element_size()  # read once, written once
    for kernel, (fn, plain_fn, lib_fn, what) in timed.items():
        ms = cuda_ms(fn, 20)
        plain_ms = cuda_ms(plain_fn, 3)
        lib_ms = cuda_ms(lib_fn, 20) if lib_fn else None
        bound_ms, bound_by = bound(state_bytes)
        results[kernel] = dict(max_abs_err=worst[kernel], ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
        log(f"[net] {kernel}, {what}, 65536 x 10: kernel {ms:.4f} ms ({_fmt_ms(graph_ms(fn))} "
            f"in a CUDA graph), plain {plain_ms:.4f} ms, "
            f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
            f"bound {bound_ms * 1e3:.3f} us ({bound_by})")
    # the full-sort designs on the same state, and the 136-launch rows of
    # exp_bitonic2 and exp_bitonic4: events (host launches included)
    # against a CUDA graph's replay (without them)
    from henjou_torch.tools import exp_bitonic2, exp_bitonic4
    from henjou_torch.tools.exp_bitonic import host_walk
    from henjou_torch.tools.exp_bitonic2 import sort_per_plane

    subs = bn.substages(n)
    kops = bn.ops()
    for tool, names in ((exp_bitonic2, "abdef"), (exp_bitonic4, ("x1", "x2", "x3", "x4"))):
        for row in names:
            g_ms = graph_ms(tool.row_fn(row, st, kops, len(subs)))
            log(f"[net] {tool.__name__.rsplit('.', 1)[1]} row {row.upper()}, {len(subs)} launches: "
                f"{_fmt_ms(g_ms)} in a CUDA graph"
                + ("" if g_ms is None else f" ({g_ms / len(subs) * 1e3:.3f} us per launch)"))
    # device time per launch inside the rows, from torch.profiler's kernel
    # events
    profiled = (("A", exp_bitonic2.row_fn("a", st, kops, len(subs))),
                ("C", exp_bitonic2.row_fn("c", st, kops, len(subs))),
                ("D", exp_bitonic2.row_fn("d", st, kops, len(subs))),
                ("E", exp_bitonic2.row_fn("e", st, kops, len(subs))),
                ("G", lambda: sort_per_plane(st, subs, kops)),
                ("host walk", lambda: host_walk(st, subs, kops)))
    per_row = net_device_us(bn, profiled)
    for label, _ in profiled:
        if per_row is None:
            log(f"[net] row {label}: torch.profiler showed no complete device time; "
                "the graph times above stand")
            continue
        log(f"[net] row {label}, device time (torch.profiler): " + ", ".join(
            f"{kernel} {count} launches, {us:.3f} us per launch"
            for kernel, (count, us) in per_row[label].items()))
    designs = {
        "net_walk, switch, double-buffered": lambda: bn.net_walk(st, sched, switch=True),
        "net_walk, j as read, double-buffered": lambda: bn.net_walk(st, sched),
        "net_walk, switch, in place": lambda: bn.net_walk(buf.copy_(st), sched, inplace=True,
                                                          switch=True),
        "host walk: net_local + net_substage (28 launches)": lambda: host_walk(st, subs, kops),
        "136 per-plane net_substage (row G)": lambda: sort_per_plane(st, subs, kops),
        "bitonic_sort (one network launch, whole words)":
            lambda: bitonic.bitonic_sort(st[0], *st[1:]),
        "argsort + gather (library)": lambda: argsort_gather(st[0], *st[1:]),
    }
    for label, fn in designs.items():
        ms = cuda_ms(fn, 20)
        g_ms = graph_ms(fn)
        log(f"[net] full sort 65536 x 10, {label}: {ms:.4f} ms per call (events), "
            f"{_fmt_ms(g_ms)} in a CUDA graph")
    log(f"[net] phase 13 in {time.monotonic() - t0:.2f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    from henjou_torch import csrc
    from henjou_torch.accel import bitonic, pallas_binned, pallas_cluster_hbm
    from henjou_torch.bsdf import dispatch
    from henjou_torch.sampling import cmj

    dev = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {device_name} (torch {torch.__version__}, CUDA {torch.version.cuda}); {smi}")

    t0 = time.monotonic()
    csrc.load_library()
    log(f"[build] csrc/*.cu -> {csrc.library_path().name}: {time.monotonic() - t0:.2f} s "
        f"({'compiled' if csrc.BUILD_SECONDS['built'] else 'already built'})")

    results = {}
    phase_sort(dev, results)
    phase_intersect(dev, results)
    phase_cluster_intersect(dev, results)
    phase_engine(dev)
    ref_launches = phase_engine_ref(dev)
    phase_light_query(dev)

    def zero():
        for m in (bitonic, pallas_binned, pallas_cluster_hbm, cmj, dispatch):
            m.LAUNCHES = 0

    def counts():
        return {"bitonic": bitonic.LAUNCHES, "binned": pallas_binned.LAUNCHES,
                "cmj": cmj.LAUNCHES, "bsdf": dispatch.LAUNCHES}

    with tempfile.TemporaryDirectory() as tmp:
        # the main path: the gallery in every render mode, then the contest
        # option file as shipped
        zero()
        phase_gallery(tmp)
        after_gallery = (bitonic.LAUNCHES, pallas_binned.LAUNCHES)
        if min(after_gallery) == 0:
            raise AssertionError(f"[gallery] a kernel was not launched: {after_gallery}")
        phase_gallery_modes(tmp)
        after_modes = (bitonic.LAUNCHES, pallas_binned.LAUNCHES)
        aovs0 = phase_contest(dev, tmp)
        launches = counts()
        if min(launches[k] - v for k, v in zip(("bitonic", "binned"), after_modes)) <= 0:
            raise AssertionError(f"[contest] a kernel was not launched: {launches}")
        log(f"[launches] main path (gallery in four modes + contest as shipped): {launches}")
        phase_denoiser(dev, aovs0)
        # this slice's path: the scale test and contest frame 0 with mis_mode="ref"
        zero()
        phase_scale(dev)
        after_scale = (bitonic.LAUNCHES, pallas_binned.LAUNCHES, pallas_cluster_hbm.LAUNCHES)
        phase_contest(dev, tmp, mis_mode="ref")
        slice_launches = {"bitonic": bitonic.LAUNCHES, "binned": pallas_binned.LAUNCHES,
                          "cluster_hbm": pallas_cluster_hbm.LAUNCHES}
        if min(bitonic.LAUNCHES - after_scale[0], pallas_binned.LAUNCHES - after_scale[1]) <= 0:
            raise AssertionError(f"[contest ref] a kernel was not launched: {slice_launches}")
        log(f"[launches] slice path (scale test + contest mis_mode=ref): {slice_launches}")
        # this slice's paths, each counted alone: the OBJ option file, the
        # masked engine on the gallery and at contest scale, then animated
        # geometry
        t0 = time.monotonic()
        zero()
        phase_obj(tmp)
        by_path = {"obj": counts()}
        by_path["masked_gallery"] = phase_masked_gallery(dev, zero, counts)
        zero()
        phase_contest(dev, tmp, engine="masked")
        by_path["masked_contest"] = counts()
        log(f"[phases 16-18] {time.monotonic() - t0:.2f} s")
        t0 = time.monotonic()
        by_path["anim"] = phase_anim(dev, results, zero, counts)
        log(f"[phase 19] {time.monotonic() - t0:.2f} s")
        # the opt-in options, each counted alone: Sobol, RIS lights,
        # adaptive allocation, the pool re-sort, two processes sharding spp
        t0 = time.monotonic()
        by_path["sobol"] = phase_sobol(dev, zero, counts)
        by_path["light_ris"], by_path["adaptive"] = phase_ris_adaptive(dev, zero, counts)
        by_path["pool_sort"] = phase_pool_sort(dev, zero, counts)
        by_path["sharded"] = phase_sharded(dev, tmp)
        log(f"[phases 20-23] {time.monotonic() - t0:.2f} s")
        # the public API: wavefront_pathtrace's default intersector
        t0 = time.monotonic()
        by_path["api"] = phase_api(dev, zero, counts)
        log(f"[phase 24] {time.monotonic() - t0:.2f} s")
        t0 = time.monotonic()
        phase_cmj(dev, results)
        log(f"[phase 25] {time.monotonic() - t0:.2f} s")
        t0 = time.monotonic()
        phase_bsdf(dev, results)
        log(f"[phase 26] {time.monotonic() - t0:.2f} s")
        for path, got in by_path.items():
            if min(got.values()) == 0:
                raise AssertionError(f"[{path}] a kernel was not launched: {got}")
            log(f"[launches] {path} path: {got}")
    log(f"[launches] two-sample engine phase (cluster kernels): {ref_launches}")
    launches.update(cluster=ref_launches["cluster"], mxu=ref_launches["mxu"],
                    cluster_hbm=slice_launches["cluster_hbm"])
    # this slice's path: the bitonic-schedule tools' rows
    launches.update(phase_bitonic_net(dev, results))

    table = [
        ("bitonic_sort", "bitonic", "bitonic.cu", "henjou_tpu/accel/bitonic.py:54"),
        ("binned_intersect", "binned", "binned.cu", "henjou_tpu/accel/pallas_binned.py:482"),
        ("cluster_intersect", "cluster", "cluster.cu", "henjou_tpu/accel/pallas_cluster.py:115"),
        ("cluster_hbm_intersect", "cluster_hbm", "cluster_hbm.cu",
         "henjou_tpu/accel/pallas_cluster_hbm.py:111"),
        ("mxu_intersect", "mxu", "mxu.cu", "henjou_tpu/accel/pallas_mxu.py:156"),
        ("cmj_draw", "cmj", "cmj.cu", "none: henjou_tpu/sampling/cmj.py and sobol.py are "
                                      "plain jnp code"),
        ("bsdf_dispatch", "bsdf", "bsdf.cu", "none: henjou_tpu/bsdf/ is plain jnp code"),
    ] + [(k, k, "bitonic_net.cu", NET_REPLACES[k]) for k in NET_REPLACES]
    kernels = [
        dict(name=name, route="cuda", source=f"henjou_torch/csrc/{src}", replaces=replaces,
             launches=launches[key],
             **({"launches_by_path": {p: got[key] for p, got in by_path.items()}}
                if key in ("bitonic", "binned", "cmj", "bsdf") else {}),
             **{f: results[key][f] for f in ("max_abs_err", "ms", "sorted_ms", "masked_ms",
                                             "graph_ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "by_shape", "plain_graph_ms",
                                             "plain_launches", "resources")
                if f in results[key]})
        for name, key, src, replaces in table
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
