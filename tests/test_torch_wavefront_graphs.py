"""The wavefront engine's iteration as CUDA-graph segments
(`henjou_torch/integrator/wavefront.py`) and what it rests on.

On the CPU: `closest_hit` is its intersect call followed by
`fill_payload`, bit for bit, under the plain binned intersector, on the
flag sets of the repo's test scenes (no maps and a constant sky; base
colour maps and the HDR sky); the refill's device counters (`_refill`)
give the (pixel, spp) sequence of the loop's former host wrap arithmetic
for groups smaller than, equal to and larger than the pool, and with
adaptive counts; a CPU render keeps no plan.

On the card (`-m cuda`): the graph path against the same iteration run
eagerly on the card, bit-equal at 1 spp with no more lanes than pixels
(each pixel takes one add) in pathtrace, NEE, one- and two-sample MIS and
the opt-in forms (the pool re-sort, adaptive counts, Sobol, RIS), over
two calls with different seeds and spp offsets, with equal launch counts
and counters; a render in groups of two sizes captures once per (frame,
size) and replays the rest; the next frame's camera on the same plans
captures anew and renders its own rays; the hooked trace calls still run
once per trace; a profiler session after the captures records the
kernels. The counts are taken with `timer.tally`, so no profiler
session opens around a capture. This file imports no JAX, so on the
card:

    python -m pytest tests/test_torch_wavefront_graphs.py -m cuda --noconftest -q
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from henjou_torch.accel import bitonic, pallas_binned
from henjou_torch.accel.pallas_binned import make_binned_intersector, pack_binned_np
from henjou_torch.accel.sorting import ray_sort_key, sorted_binned_intersector
from henjou_torch.bsdf import dispatch
from henjou_torch.bsdf.dispatch import bsdf_eval, bsdf_pdf, make_bsdf_sampler
from henjou_torch.integrator import wavefront
from henjou_torch.integrator.payload import Sky, closest_hit, fill_payload
from henjou_torch.math.constants import TMAX_RAY, ray_eps
from henjou_torch.runtime.camera import make_camera
from henjou_torch.sampling import cmj
from henjou_torch.sampling.cmj import SOBOL_SEED_FLAG
from henjou_torch.scene import testscenes
from henjou_torch.scene.scenedata import build_device_scene, build_frame_scene
from henjou_torch.texture.ibl import load_ibl
from henjou_torch.utils import timer

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

CAM = ((0.0, 1.2, -9.0), (0.0, -0.05, 1.0), np.radians(45.0))
SKY = (0.3, 0.4, 0.55)


def _frame(scene, device):
    return build_frame_scene(build_device_scene(scene, device))


# ---------------------------------------------------------------- CPU


def _fill_rays(frame, n, seed):
    """Half the rays from inside the scene box in random directions, half
    aimed at random triangle centroids; a few with tmax 0 (dead lanes)."""
    g = torch.Generator().manual_seed(seed)
    tv = frame.tri_verts
    lo, hi = tv.reshape(-1, 3).amin(0), tv.reshape(-1, 3).amax(0)
    o = lo + (hi - lo) * torch.rand(n, 3, generator=g)
    tgt = tv[torch.randint(0, tv.shape[0], (n,), generator=g)].mean(1)
    d = torch.where(torch.arange(n)[:, None] % 2 == 0, torch.randn(n, 3, generator=g), tgt - o)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    tmax = torch.where(torch.arange(n) % 17 == 0, 0.0, TMAX_RAY)
    return o, d, tmax


@pytest.mark.parametrize("name", ["gallery", "cornell", "rtcamp"])
def test_closest_hit_is_intersect_then_fill_payload(name):
    if name == "rtcamp":
        # base colour maps, 18 emitters, the HDR sky
        frame = _frame(testscenes.rtcamp_scene(grid=2, lat=8, lon=16), "cpu")
        sky = Sky(constant_color=torch.tensor(SKY), intensity=torch.tensor(1.5), use_ibl=True,
                  ibl_texture=load_ibl("scenes/rtcamp_sky.hdr", "cpu"))
        assert frame.device.has_base_tex
    else:
        scene = (testscenes.sphere_gallery_scene() if name == "gallery"
                 else testscenes.cornell_box_scene())
        frame = _frame(scene, "cpu")
        sky = Sky(constant_color=torch.tensor(SKY), intensity=torch.tensor(1.0))
    ifn, _ = make_binned_intersector(pack_binned_np(frame.tri_verts.numpy(), "cpu"))
    o, d, tmax = _fill_rays(frame, 2048, 3)
    eps = ray_eps(frame)
    want = closest_hit(frame, sky, o, d, eps, tmax, ifn)
    got = fill_payload(frame, sky, o, d, *ifn(frame.tri_verts, o, d, eps, tmax))
    assert 0 < int(want.is_hit.sum()) < 2048
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and (torch.equal(a, b) or torch.allclose(
            a, b, rtol=0, atol=0, equal_nan=True)), f


def _host_refill(h, done, n_pixels, spp, total_samples, n_wraps, adaptive=None):
    """The loop's former arithmetic: the refill's (pixel, spp, can_spawn)
    from host counters h, then the host's advance of h after the read-back."""
    rank = torch.cumsum(done.to(torch.int64), dim=0) - 1
    if adaptive is not None:
        incl, offs, base = adaptive
        s_idx = h["counter"] + rank
        can_spawn = done & (s_idx < incl[-1])
        q = torch.clamp(torch.searchsorted(incl, s_idx, right=True), max=n_pixels - 1)
        s_pix, s_spp = q, torch.clamp(base[q] + s_idx - offs[q], min=0)
    else:
        s_pix = h["ctr_pix"] + rank
        s_spp = torch.full_like(s_pix, h["ctr_spp"])
        for _ in range(n_wraps):
            wrap = s_pix >= n_pixels
            s_pix = s_pix - torch.where(wrap, n_pixels, 0)
            s_spp = s_spp + wrap.to(torch.int64)
        can_spawn = done & (s_spp < spp)
    n_done = int(done.sum())
    h["counter"] = min(h["counter"] + n_done, total_samples)
    h["ctr_pix"] += n_done
    for _ in range(n_wraps):
        if h["ctr_pix"] >= n_pixels:
            h["ctr_pix"] -= n_pixels
            h["ctr_spp"] += 1
    return s_pix, s_spp, can_spawn


@pytest.mark.parametrize("n_pixels,spp,adaptive", [
    (300, 5, False), (1024, 3, False), (5000, 2, False), (1024, 1, False), (700, 3, True),
    (3000, 2, True)])
def test_device_refill_counters_match_the_host_wrap_arithmetic(n_pixels, spp, adaptive):
    lanes = 1024
    g = torch.Generator().manual_seed(n_pixels + spp)
    total = n_pixels * spp
    c = SimpleNamespace(n_pixels=n_pixels, spp=spp, n_wraps=lanes // n_pixels + 1,
                        total_samples=total, adaptive=adaptive)
    p = SimpleNamespace(counter=torch.tensor(min(lanes, total)),
                        ctr_pix=torch.tensor(lanes % n_pixels),
                        ctr_spp=torch.tensor(lanes // n_pixels))
    ad = None
    if adaptive:
        # the counts sum to at most the budget
        counts = torch.randint(0, spp + 1, (n_pixels,), generator=g)
        p.incl = torch.cumsum(counts, 0)
        p.offs = p.incl - counts
        p.base = torch.randint(0, 4, (n_pixels,), generator=g)
        ad = (p.incl, p.offs, p.base)
    h = dict(counter=min(lanes, total), ctr_pix=lanes % n_pixels, ctr_spp=lanes // n_pixels)
    # through the budget and past it (the counters keep wrapping; no lane
    # may spawn there)
    for step in range(60):
        done = torch.rand(lanes, generator=g) < (0.05 if step % 3 else 0.6)
        want = _host_refill(h, done, n_pixels, spp, total, c.n_wraps, ad)
        *got, (counter, ctr_pix, ctr_spp) = wavefront._refill(c, p, done)
        for a, b in zip(want, got):
            assert torch.equal(a, b), step
        assert (int(counter), int(ctr_pix), int(ctr_spp)) == (
            h["counter"], h["ctr_pix"], h["ctr_spp"]), step
        p.counter, p.ctr_pix, p.ctr_spp = counter, ctr_pix, ctr_spp
    assert h["counter"] == total and not bool(want[2].any())


def test_cpu_render_keeps_no_plan():
    frame = _frame(testscenes.cornell_box_scene(), "cpu")
    sky = Sky(constant_color=torch.tensor(SKY), intensity=torch.tensor(1.0))
    cam = make_camera((0.0, 1.0, -3.5), (0.0, 0.0, 1.0), np.radians(45.0), "cpu")
    plans = {}
    film = wavefront.wavefront_render(frame, sky, cam, 8, 8, 1, make_bsdf_sampler(None),
                                      lanes=64, max_depth=3, plans=plans)
    assert not plans and float(film.count.sum()) == 64.0


# ---------------------------------------------------------------- card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the graphs and the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _gallery(dev, raw=False):
    """The gallery frame, its sky and its traces: the sorted wrappers, or
    with `raw` the raw binned kernels and the pool re-sort's key."""
    frame = _frame(testscenes.sphere_gallery_scene(), dev)
    pack = pack_binned_np(frame.tri_verts.cpu().numpy(), dev)
    sky = Sky(constant_color=torch.tensor(SKY, device=dev), intensity=torch.tensor(1.0, device=dev))
    if not raw:
        return frame, sky, *sorted_binned_intersector(pack)
    lo = pack.scene_lo.to(torch.float32)
    inv_extent = 1.0 / torch.clamp(pack.scene_hi.to(torch.float32) - lo, min=1e-12)
    return (frame, sky, *make_binned_intersector(pack),
            lambda o, d: ray_sort_key(o, d, lo, inv_extent))


BSDF = {"sample": make_bsdf_sampler(None), "eval": lambda h, wo, wi: bsdf_eval(h, wo, wi, None)}
SEED = 12345678901


def _render(frame, sky, cam, ifn, ofn, integrator, mis_single=True, **kw):
    kw = {"seed": SEED, **kw}
    return wavefront.wavefront_render(
        frame, sky, cam, 32, 32, 1, BSDF["sample"], bsdf_eval=BSDF["eval"], bsdf_pdf=bsdf_pdf,
        integrator=integrator, lanes=1024, max_depth=4, intersect_fn=ifn,
        occluded_fn=ofn, mis_single=mis_single, **kw)


def _eager(monkeypatch):
    """No graphs: the iteration runs eagerly on the card."""
    monkeypatch.setattr(wavefront, "_captures", lambda device: False)


def _films_equal(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


KERNELS = (bitonic, pallas_binned, cmj, dispatch)


def _counted(fn):
    """(result, the timer's counts, each KERNELS module's LAUNCHES rise) of
    fn(), with no profiler session open."""
    before = [m.LAUNCHES for m in KERNELS]
    with timer.tally() as counts:
        out = fn()
    return out, counts, [m.LAUNCHES - b for m, b in zip(KERNELS, before)]


def _opt_in(form, n_pixels, dev):
    """The keyword arguments of an opt-in form for a 1-spp render of
    `n_pixels`: adaptive counts of 0 or 1 (at most one add a pixel) from
    drawn bases, Sobol, or eight RIS candidates."""
    if form == "adaptive":
        g = torch.Generator().manual_seed(5)
        return dict(sample_counts=torch.randint(0, 2, (n_pixels,), generator=g).to(dev),
                    sample_base=torch.randint(0, 9, (n_pixels,), generator=g).to(dev))
    if form == "sobol":
        return dict(sobol=True)
    if form == "ris":
        return dict(light_ris=8)
    return {}


@pytest.mark.cuda
@pytest.mark.parametrize("integrator,mis_single,form", [
    ("pathtrace", True, None), ("nee", True, None), ("mis", True, None), ("mis", False, None),
    ("mis", True, "pool"), ("mis", True, "adaptive"), ("mis", True, "sobol"),
    ("mis", True, "ris")])
def test_graph_film_bit_equal_to_eager(cuda, monkeypatch, integrator, mis_single, form):
    """Two calls on one plan, the second with another seed and spp offset
    (device scalars, not baked into the graphs), against the same calls
    run eagerly: bit-equal films, and equal launch counts and counters
    (a replay counts what its capture launched)."""
    frame, sky, *traces = _gallery(cuda, raw=form == "pool")
    ifn, ofn = traces[:2]
    kw = _opt_in(form, 1024, cuda)
    if form == "pool":
        kw["pool_key_fn"] = traces[2]
    seeds = [dict(seed=SEED, spp_offset=0), dict(seed=SEED + 77, spp_offset=3)]
    if form == "sobol":
        seeds = [dict(s, seed=s["seed"] & 0x7FFFFFFF | SOBOL_SEED_FLAG) for s in seeds]
    cam = make_camera(*CAM, cuda)
    plans = {}
    graph, counts, launches = _counted(lambda: [
        _render(frame, sky, cam, ifn, ofn, integrator, mis_single, plans=plans, **kw, **s)
        for s in seeds])
    assert len(plans) == 1 and next(iter(plans.values())).segments
    assert counts["engine.graph_replays"] > counts["engine.graph_captures"] > 0
    with monkeypatch.context() as m:
        _eager(m)
        eager, e_counts, e_launches = _counted(lambda: [
            _render(frame, sky, cam, ifn, ofn, integrator, mis_single, **kw, **s)
            for s in seeds])
    assert "engine.graph_captures" not in e_counts
    for c in (counts, e_counts):
        c.pop("engine.graph_captures", None), c.pop("engine.graph_replays", None)
    assert counts == e_counts and launches == e_launches
    assert counts["sampling.draws_kernel"] > 0 and launches[2] > 0
    for g, e in zip(graph, eager):
        assert float(e.count.sum()) == (float(kw["sample_counts"].sum())
                                        if form == "adaptive" else 1024.0)
        assert int(e.n_traces) > 0
        _films_equal(g, e)
    assert not torch.equal(graph[0].color, graph[1].color)


@pytest.mark.cuda
def test_groups_of_two_sizes_capture_once_per_size(cuda, monkeypatch):
    frame, sky, ifn, ofn = _gallery(cuda)
    cam = make_camera(*CAM, cuda)
    groups = [(0, 300), (300, 300), (600, 300), (900, 124)]
    plans = {}
    b0, l0 = bitonic.LAUNCHES, pallas_binned.LAUNCHES
    films, counters, _ = _counted(lambda: [
        _render(frame, sky, cam, ifn, ofn, "mis", pixel_base=b, pixel_count=n, plans=plans)
        for b, n in groups])
    # one-sample MIS: three segments an iteration, two keys, each with an
    # eager first iteration and a captured second
    assert counters["engine.graph_captures"] == 2 * 3
    iters = counters["engine.lane_slots"] // 1024
    assert counters["engine.graph_replays"] == 3 * (iters - 4)
    assert len(plans) == 2
    # two traces an iteration, each one binned call and a sort and an unsort
    assert pallas_binned.LAUNCHES - l0 == 2 * iters
    assert bitonic.LAUNCHES - b0 == 4 * iters
    with monkeypatch.context() as m:
        _eager(m)
        eager = [_render(frame, sky, cam, ifn, ofn, "mis", pixel_base=b, pixel_count=n)
                 for b, n in groups]
    for g, e in zip(films, eager):
        _films_equal(g, e)


@pytest.mark.cuda
def test_a_moved_camera_captures_anew(cuda, monkeypatch):
    frame, sky, ifn, ofn = _gallery(cuda)
    cam0 = make_camera(*CAM, cuda)
    cam1 = make_camera((0.6, 1.4, -8.5), (-0.05, -0.08, 1.0), np.radians(40.0), cuda)
    plans = {}
    _render(frame, sky, cam0, ifn, ofn, "mis", plans=plans)
    f0, c0, _ = _counted(lambda: _render(frame, sky, cam0, ifn, ofn, "mis", plans=plans))
    assert "engine.graph_captures" not in c0 and c0["engine.graph_replays"] > 0
    # the same dict, the next frame's camera: the first frame's plan goes
    f1, c1, _ = _counted(lambda: _render(frame, sky, cam1, ifn, ofn, "mis", plans=plans))
    assert c1["engine.graph_captures"] == 3
    assert len(plans) == 1 and next(iter(plans.values())).objs[2] is cam1
    with monkeypatch.context() as m:
        _eager(m)
        e0 = _render(frame, sky, cam0, ifn, ofn, "mis")
        e1 = _render(frame, sky, cam1, ifn, ofn, "mis")
    _films_equal(f0, e0)
    _films_equal(f1, e1)
    assert not torch.equal(f1.color, f0.color)


@pytest.mark.cuda
def test_a_profiler_session_after_captured_graphs_records_the_kernels(cuda):
    """In a fresh process, as the benchmark's traced frame runs: a plan
    captured with no profiler session, then one session records the
    kernels of the eager traces (`walk_kernel`) and of the replayed
    segments (`cmj_draw`), and the launch calls."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import sys\n"
        f"sys.path[:0] = [{here!r}, {os.path.dirname(here)!r}]\n"
        "import torch\n"
        "from torch.profiler import ProfilerActivity, profile\n"
        "import test_torch_wavefront_graphs as t\n"
        "dev = torch.device('cuda', 0)\n"
        "frame, sky, ifn, ofn = t._gallery(dev)\n"
        "cam = t.make_camera(*t.CAM, dev)\n"
        "plans = {}\n"
        "t._render(frame, sky, cam, ifn, ofn, 'mis', plans=plans)\n"
        "assert next(iter(plans.values())).segments\n"
        "with profile(activities=[ProfilerActivity.CUDA]) as prof:\n"
        "    t._render(frame, sky, cam, ifn, ofn, 'mis', plans=plans)\n"
        "    torch.cuda.synchronize()\n"
        "ev = list(prof.profiler.kineto_results.events())\n"
        "dev_ev = [e for e in ev if str(e.device_type()).endswith('CUDA')]\n"
        "calls = [e for e in ev if e.name() in ('cudaLaunchKernel', 'cudaGraphLaunch')]\n"
        "print(len(dev_ev), len(calls))\n"
        "names = ' '.join(e.name() for e in dev_ev)\n"
        "assert 'walk_kernel' in names and 'cmj_draw' in names and calls\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)
    assert done.returncode == 0, done.stdout + done.stderr
