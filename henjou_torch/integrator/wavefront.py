"""Wavefront engine with lane refill (port of henjou_tpu/integrator/wavefront.py).

A fixed pool of `lanes` lanes; every iteration each lane advances its
path by one bounce, and finished lanes refill at once with the next
(pixel, spp) sample, so occupancy stays near 100% until the tail. The CMJ
sampler is counter-based, so a refilled lane draws exactly the stream
its sample would have drawn anywhere else.

Estimators: pathtrace (radiance trace only), nee (+ light sample and
shadow trace) and mis in two forms:

- ``mis_single=True``, the one-sample form: the path-continuation BSDF
  draw is the MIS BSDF branch, its emission is collected at the next
  radiance hit with a balance weight against the reverse light pdf of the
  prim hit, and paths get one extra emission-only segment at
  depth == max_depth;
- ``mis_single=False`` (``mis_mode="ref"``), the reference's two-sample
  form: an independent BSDF-branch draw per bounce whose hit is only used
  when it is a light or a miss. It is traced as a dense or binned closest
  hit against the emissive triangles (`light_isect_fn`, default
  `intersect_lights`) plus a bounded any-hit query up to that light, and
  `closest_hit` is fed the synthesized result.

Opt-in forms, as in the JAX engine:

- ``sobol=True``: lanes whose seed carries SOBOL_SEED_FLAG draw the
  Owen-scrambled Sobol sequence (`sampling/sobol.py`);
- ``light_ris=m >= 2``: NEE picks its light by resampling m candidates
  (`sample_light_ris`); the contribution divides by the resampled density
  and the MIS weight takes the kept candidate's plain pdf;
- ``sample_counts`` (adaptive allocation): chunk-local pixel p takes
  sample_counts[p] samples from absolute index sample_base[p] on; a
  sample index maps to its pixel by a search of the counts' inclusive
  prefix;
- ``pool_key_fn`` (HENJOU_POOL_SORT): after every bounce the whole pool
  is sorted by its outgoing rays' key, carrying all 27 per-lane columns
  through `bitonic_sort` (lane order is free: the film goes through
  `pix`, the sampler through counters), so the raw kernels see coherent
  rays without a sort and unsort around each trace.

Differences from the JAX engine, none of which change an estimate:

- `jax.lax.while_loop` is a Python loop; its condition reads two counts
  back from the device once per iteration (three with adaptive counts:
  their sum rides the same read).
- The film update `.at[pix].add` is `index_add_`, which on CUDA uses
  atomics: per-pixel sums are taken in a varying order.
- The trace count is an exact int64 instead of an f32 sum.

One iteration is written once, as `_iteration`: a generator that yields
at each call the engine was handed from outside (the radiance trace
`intersect_fn`, the any-hit `occluded_fn`, the two-sample form's
`light_isect_fn`, the pool re-sort `pool_sort` with `pool_key_fn`) and
receives its results. The pieces between those calls are its segments:
three a bounce on the default one-sample MIS path (the roulette draw; the
payload fill, emission weights and light sample; the NEE contribution,
continuation, film scatter and refill). Every piece of the lane pool's
state lives in device buffers that the segments update in place, the
refill's counters and the call's seed, first pixel and spp offset
included, so a segment's work is fixed by the buffers' addresses. On CUDA
each segment is captured as a CUDA graph and replayed after that; the
injected calls run eagerly between them, and their outputs are copied
into the next segment's static inputs. On the CPU the same
generator runs eagerly. The host still reads the loop's counts back once
per iteration, as before.

A call keeps its plan (the lane buffers and, on CUDA, the iteration's
graphs) in the `plans` dict its caller hands it, for later calls of the
same frame with the same sizes and options (`Renderer.render_frame` makes
one dict a frame and passes it to every pixel group and batch); a dict
holds one frame's plans, and a call with another frame's objects empties
it first. Without a dict a call's plan lives for the call. A plan's first
iteration runs eagerly, so that kernels load and lazy tables build
outside a capture; its second is captured.

Under a profiler (`utils/timer.py`) each iteration is an `engine.bounce`
span, and the loop counts its lane slots (`engine.lane_slots`, lanes
times iterations) and the valid lanes among them (`engine.lanes_valid`)
from the read-back it already does, and its segments captured
(`engine.graph_captures`) and replayed (`engine.graph_replays`). A
replay adds again what its segment counted at capture: the `LAUNCHES` of
the CMJ and BSDF kernel wrappers and the timer's counters
(`sampling.draws*`, `bsdf.calls*`), so they stay counts of launches on
the device. Spans inside a segment record only when it runs eagerly or
is captured.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, NamedTuple, Optional

import torch

from henjou_torch.accel import bitonic
from henjou_torch.accel.bruteforce import intersect_bruteforce, occluded_bruteforce
from henjou_torch.accel.sorting import DEAD_KEY
from henjou_torch.bsdf import dispatch
from henjou_torch.integrator.pathtrace import MAX_DEPTH
from henjou_torch.integrator.payload import Sky, fill_payload
from henjou_torch.math.constants import SHADOW_EPS_REL, TMAX_RAY, ray_eps
from henjou_torch.math.vec import absdot, dot, length, local_to_world, orthonormal_basis, world_to_local
from henjou_torch.runtime.camera import Camera, camera_rays
from henjou_torch.sampling import cmj
from henjou_torch.sampling.cmj import M32, CMJState, cmj_1d, cmj_2d, make_cmj_state
from henjou_torch.sampling.light_sample import (
    intersect_lights,
    light_table,
    sample_light,
    sample_light_ris,
)
from henjou_torch.scene.scenedata import FrameScene
from henjou_torch.utils import timer
from henjou_torch.utils.timer import span


class WavefrontFilm(NamedTuple):
    color: torch.Tensor  # [P,3]
    albedo: torch.Tensor  # [P,3]
    normal: torch.Tensor  # [P,3]
    n_traces: torch.Tensor  # 0-d int64, honest trace count
    m2: torch.Tensor  # [P] sum of per-sample luminance^2
    count: torch.Tensor  # [P] samples accumulated per pixel


# Rec.709 luma weights for the per-sample second moment
_LUMA = (0.2126, 0.7152, 0.0722)


# the per-lane fields of a CMJState (its `sobol` flag is per renderer)
_LANE_FIELDS = ("n_spp", "scramble", "depth", "image_idx")


def _where_state(mask, a: CMJState, b: CMJState) -> CMJState:
    return b._replace(**{f: torch.where(mask, getattr(a, f), getattr(b, f))
                         for f in _LANE_FIELDS})


def _as_i32(x):
    """u32 values held in int64 as int32 with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


# the kernel wrappers whose `LAUNCHES` a segment's replay adds to
_KERNEL_COUNTERS = (cmj, dispatch)


def _captures(device) -> bool:
    """Whether the iteration on `device` runs as CUDA graphs."""
    return device.type == "cuda"


class _Segment(NamedTuple):
    """A captured piece of the iteration: its graph; the injected call
    that follows it (None for the last), with that call's arguments and
    the static tensors its outputs are copied into; the rise of each
    `_KERNEL_COUNTERS` module's `LAUNCHES` and the timer's counts that its
    capture made."""

    graph: object
    role: Optional[str]
    args: Optional[tuple]
    results: Optional[tuple]
    launches: tuple
    counts: dict


class _Plan:
    """One key's constants `c`, lane pool buffers `p`, the frame's objects
    it was made for, and, once captured, the iteration's segments."""

    def __init__(self, c, p, objs: tuple, graphs: bool):
        self.c, self.p, self.objs = c, p, objs
        self.graphs = graphs
        self.warm = False  # its eager first iteration has run
        self.segments = None
        self.reads = None

    def serves(self, objs: tuple) -> bool:
        return all(a is b for a, b in zip(self.objs, objs))


def _replayed(seg: _Segment) -> None:
    """Count a replay of `seg` as its capture counted its launches."""
    for mod, n in zip(_KERNEL_COUNTERS, seg.launches):
        mod.LAUNCHES += n
    for name, n in seg.counts.items():
        timer.count(name, n)


def _step(plan: _Plan, calls: dict):
    """One iteration of the pool: its segments replayed, captured (and each
    run once), or run eagerly (the CPU; a plan's first iteration on the
    card); `calls[role](*args)` makes each injected call eagerly between
    them and returns a tuple. Returns the loop's read-back as one device
    tensor."""
    if plan.segments is not None:
        for seg in plan.segments:
            seg.graph.replay()
            _replayed(seg)
            if seg.role is not None:
                for dst, src in zip(seg.results, calls[seg.role](*seg.args)):
                    dst.copy_(src)
        timer.count("engine.graph_replays", len(plan.segments))
        return plan.reads
    gen = _iteration(plan.c, plan.p)
    if not plan.graphs or not plan.warm:
        plan.warm = True
        out = None
        while True:
            try:
                role, args = gen.send(out)
            except StopIteration as stop:
                return stop.value
            out = calls[role](*args)
    device = plan.p.film.device
    stream = torch.cuda.Stream(device)
    pool = torch.cuda.graph_pool_handle()  # shared by the segments, in order
    segments, out = [], None
    while True:
        graph = torch.cuda.CUDAGraph()
        before = tuple(mod.LAUNCHES for mod in _KERNEL_COUNTERS)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream), timer.tally() as counts:
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                step = gen.send(out)
            except StopIteration as stop:
                step = stop.value
            finally:
                graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(stream)
        graph.replay()
        launches = tuple(mod.LAUNCHES - b for mod, b in zip(_KERNEL_COUNTERS, before))
        if not isinstance(step, tuple):
            segments.append(_Segment(graph, None, None, None, launches, counts))
            break
        role, args = step
        # the segment's static inputs: copies made outside every graph
        out = tuple(x.clone() for x in calls[role](*args))
        segments.append(_Segment(graph, role, args, out, launches, counts))
    timer.count("engine.graph_captures", len(segments))
    plan.segments, plan.reads = segments, step
    return step


def _spawn(c, p, pix, spp_idx):
    """(chunk-local pixel, spp) -> fresh path state, keyed on the global
    pixel id."""
    gpix = pix + p.pixel_base
    st = make_cmj_state(spp_idx + p.spp_offset, gpix, p.seed, sobol=c.sobol)
    return camera_rays(c.cam, c.width, c.height, gpix, st)


def _sample_at(c, p, s_idx):
    """Adaptive counts: sample index -> (chunk-local pixel, absolute spp
    index); callers gate on s_idx < the counts' sum."""
    q = torch.clamp(torch.searchsorted(p.incl, s_idx, right=True), max=c.n_pixels - 1)
    return q, torch.clamp(p.base[q] + s_idx - p.offs[q], min=0)


def _refill(c, p, done):
    """The samples that refill the `done` lanes: (chunk-local pixel, spp,
    can_spawn), and the refill counters (counter, ctr_pix, ctr_spp) that
    follow, all device tensors. Without adaptive counts a (pixel, spp)
    wrap counter, pixel-major (sample s -> pixel s % P, spp s // P); with
    them the monotonic counter indexes the sample list."""
    rank = torch.cumsum(done.to(torch.int64), dim=0) - 1
    if c.adaptive:
        s_idx = p.counter + rank
        can_spawn = done & (s_idx < p.incl[-1])
        s_pix, s_spp = _sample_at(c, p, s_idx)
    else:
        s_pix = p.ctr_pix + rank
        s_spp = p.ctr_spp.expand_as(s_pix)
        for _ in range(c.n_wraps):
            wrap = s_pix >= c.n_pixels
            s_pix = s_pix - torch.where(wrap, c.n_pixels, 0)
            s_spp = s_spp + wrap.to(torch.int64)
        can_spawn = done & (s_spp < c.spp)
    n_done = done.sum()
    counter = torch.clamp(p.counter + n_done, max=c.total_samples)
    ctr_pix, ctr_spp = p.ctr_pix + n_done, p.ctr_spp
    for _ in range(c.n_wraps):
        wrap = ctr_pix >= c.n_pixels
        ctr_pix = ctr_pix - torch.where(wrap, c.n_pixels, 0)
        ctr_spp = ctr_spp + wrap.to(torch.int64)
    return s_pix, s_spp, can_spawn, (counter, ctr_pix, ctr_spp)


def _store(p, **values) -> None:
    """Write each value into the pool buffer of its name, in place (a
    buffer given as its own value stays)."""
    for name, x in values.items():
        dst = getattr(p, name)
        if x is not dst:
            dst.copy_(x)


def _iteration(c, p):
    """One bounce of every lane, as a generator: reads the pool `p` and
    writes it back in place; yields (role, args) at each injected call and
    receives its outputs as a tuple; returns the loop's read-back [lanes
    done, lanes valid(, adaptive sample total)] as one device tensor."""
    frame, sky, lights = c.frame, c.sky, c.lights
    o, d = p.o, p.d
    # ---- Russian roulette (the draw precedes the trace) ----
    u_rr, st = cmj_1d(p.st)
    russian_p = p.thr.amax(dim=-1)
    survive = russian_p >= u_rr
    thr = p.thr / torch.clamp(russian_p, min=1e-12)[:, None]
    alive = p.valid & survive

    # ---- radiance trace ----
    lane_tmax = torch.where(alive, TMAX_RAY, 0.0)
    found = yield "intersect", (frame.tri_verts, o, d, c.eps_r, lane_tmax)
    with span("engine.trace"):
        hit = fill_payload(frame, sky, o, d, *found)
    n_traces = alive.sum()

    with span("engine.shade"):
        first = p.depth == 0
        aov_a = torch.where(first[:, None], hit.basecolor, p.aov_a)
        aov_n = torch.where(first[:, None], hit.normal, p.aov_n)

        terminal = (~hit.is_hit) | hit.is_light
        if c.mis_single:
            # terminal emission at every depth, balance-weighted against
            # the reverse light pdf of the prim the previous bounce's BSDF
            # draw hit (sky misses have lp = 0 -> weight 1)
            lp_area = lights.pdf_by_prim[hit.primitive_id]
            dist2 = torch.clamp(hit.t * hit.t, min=1e-24)
            cos2 = absdot(d, hit.normal)
            lp = torch.where(hit.is_light,
                             lp_area * dist2 / torch.clamp(cos2, min=1e-12), 0.0)
            w_emit = torch.where(
                first | p.prev_spec, 1.0, p.prev_pdf / torch.clamp(p.prev_pdf + lp, min=1e-12)
            )
            emit_gate = alive & terminal
            lte = p.lte + torch.where(emit_gate[:, None],
                                      thr * hit.emission * w_emit[:, None], 0.0)
        else:
            # with NEE, direct emitter/sky only at depth 0
            emit_gate = alive & terminal & first if c.use_nee else alive & terminal
            lte = p.lte + torch.where(emit_gate[:, None], thr * hit.emission, 0.0)
        alive = alive & ~terminal
        # the emission-only segment does no NEE and no continuation
        emit_seg = p.depth >= c.max_depth if c.mis_single else torch.zeros_like(alive)

        n = hit.normal
        t, b = orthonormal_basis(n)
        local_wo = world_to_local(-d, t, n, b)

    if c.use_nee:
        # ---- NEE shadow branch ----
        with span("engine.shade"):
            if c.ris:
                # l_pdf_eff divides the contribution, l_pdf weighs MIS
                (l_pos, l_normal, l_emission, l_pdf_eff, l_pdf, l_valid,
                 st) = sample_light_ris(frame, st, hit.position, n, c.light_ris, lights)
            else:
                l_pos, l_normal, l_emission, l_pdf, l_valid, st = sample_light(
                    frame, st, lights)
                l_pdf_eff = l_pdf
            to_light = l_pos - hit.position
            l_dist = torch.clamp(length(to_light), min=1e-12)
            l_dir = to_light / l_dist[:, None]
            # specular lanes contribute exactly 0 to NEE: their shadow rays
            # are zero-width, so the sort sinks them and the kernel skips
            nee_live = alive & ~hit.is_specular & ~emit_seg
        (shadow_blocked,) = yield "occluded", (
            frame.tri_verts, hit.position, l_dir, c.eps_r,
            torch.where(nee_live, l_dist * (1.0 - SHADOW_EPS_REL), 0.0))
        n_traces = n_traces + nee_live.sum()
        with span("engine.shade"):
            cos1 = absdot(n, l_dir)
            cos2 = absdot(l_normal, -l_dir)
            local_wi_l = world_to_local(l_dir, t, n, b)
            f_l = c.bsdf_eval(hit, local_wo, local_wi_l)
            g = cos2 / (l_dist * l_dist)
            if c.use_mis:
                pt_pdf_l = c.bsdf_pdf(hit, local_wo, local_wi_l) * g
                w_light = l_pdf / torch.clamp(l_pdf + pt_pdf_l, min=1e-12)
            else:
                w_light = torch.ones_like(l_pdf)
            contrib_nee = (
                thr * f_l
                * (g * cos1 / torch.clamp(l_pdf_eff, min=1e-12) * w_light)[:, None]
                * l_emission
            )
            ok = alive & ~emit_seg & l_valid & ~shadow_blocked & (l_pdf_eff > 0.0)
            lte = lte + torch.where(ok[:, None], contrib_nee, 0.0)

    if c.use_mis and not c.mis_single:
        # ---- independent BSDF-branch trace (the two-sample form) ----
        # Its hit is only used when it is a light or a miss: a closest hit
        # against the emissive triangles, then a bounded any-hit query up
        # to that light (or the scene exit), then the payload fill fed the
        # synthesized result, so textured lights shade as in a full trace.
        with span("engine.shade"):
            brdf_b, local_wi_b, pt_pdf_b, st = c.bsdf_sample(hit, local_wo, st)
            wi_b = local_to_world(local_wi_b, t, n, b)
            cos1_b = absdot(wi_b, n)
            lane_tmax_b = torch.where(alive, TMAX_RAY, 0.0)
        t_l, prim_l, u_l, v_l, hit_l, area_l = yield "light_isect", (
            hit.position, wi_b, c.eps_r, lane_tmax_b)
        (blocked_b,) = yield "occluded", (
            frame.tri_verts, hit.position, wi_b, c.eps_r,
            torch.where(hit_l, t_l * (1.0 - SHADOW_EPS_REL), lane_tmax_b))
        vis_l = hit_l & ~blocked_b
        with span("engine.trace"):
            hit_b = fill_payload(frame, sky, hit.position, wi_b,
                                 torch.where(vis_l, t_l, torch.inf),
                                 torch.where(vis_l, prim_l, -1), u_l, v_l, vis_l)
        n_traces = n_traces + alive.sum()
        with span("engine.shade"):
            cos2_b = absdot(-wi_b, hit_b.normal)
            dist_b = torch.clamp(length(hit_b.position - hit.position), min=1e-12)
            inv_g = dist_b * dist_b / torch.clamp(cos2_b, min=1e-12)
            # reverse light pdf: selection probability of the prim hit
            # over its area
            sel_l = lights.sel_by_prim[torch.clamp(prim_l, min=0).long()]
            rev_pdf = sel_l / torch.clamp(area_l, min=1e-12)
            lp = torch.where(hit.is_specular, 0.0, rev_pdf * inv_g)
            w_bsdf = pt_pdf_b / torch.clamp(pt_pdf_b + lp, min=1e-12)
            contrib_hit = (
                thr * (w_bsdf * cos1_b / torch.clamp(pt_pdf_b, min=1e-12))[:, None]
                * hit_b.emission * brdf_b
            )
            contrib_miss = (
                thr * (cos1_b / torch.clamp(pt_pdf_b, min=1e-12))[:, None]
                * hit_b.emission * brdf_b
            )
            take_hit = alive & hit_b.is_hit & hit_b.is_light
            take_miss = alive & ~hit_l & ~blocked_b
            lte = lte + torch.where(
                take_hit[:, None], contrib_hit,
                torch.where(take_miss[:, None], contrib_miss, 0.0)
            )

    # ---- path continuation ----
    with span("engine.shade"):
        if c.use_nee:
            _dead, st = cmj_2d(st)  # the reference's dead 2D draw, kept for parity
        bsdf, local_wi, pdf, st = c.bsdf_sample(hit, local_wo, st)
        wi = local_to_world(local_wi, t, n, b)
        weight = bsdf * (torch.abs(dot(wi, n)) / torch.clamp(pdf, min=1e-12))[:, None]

        depth = p.depth + 1
        done = p.valid & (~survive | terminal | (depth >= c.depth_cap))
        continuing = p.valid & ~done

        new_thr = torch.where(continuing[:, None], thr * weight, thr)
        new_o = torch.where(continuing[:, None], hit.position, o)
        new_d = torch.where(continuing[:, None], wi, d)
        prev_pdf, prev_spec = p.prev_pdf, p.prev_spec
        if c.mis_single:
            prev_pdf = torch.where(continuing, pdf, prev_pdf)
            prev_spec = torch.where(continuing, hit.is_specular, prev_spec)

    # ---- film accumulation for finished lanes (one packed scatter) ----
    with span("engine.film"):
        donef = done[:, None]
        lum = lte[:, 0] * _LUMA[0] + lte[:, 1] * _LUMA[1] + lte[:, 2] * _LUMA[2]
        lte_acc = lte
        if c.firefly_clamp > 0.0:
            scale = torch.clamp(c.firefly_clamp / torch.clamp(lum, min=1e-12), max=1.0)
            lte_acc = lte * scale[:, None]
            lum = lum * scale
        packed = torch.where(
            donef,
            torch.cat([lte_acc, aov_a, aov_n, (lum * lum)[:, None],
                       torch.ones_like(lum)[:, None]], dim=1),
            0.0,
        )
        p.film.index_add_(0, p.pix, packed)

    # ---- refill finished lanes with fresh samples ----
    with span("engine.spawn"):
        s_pix, s_spp, can_spawn, (counter, ctr_pix, ctr_spp) = _refill(c, p, done)
        s_o, s_d, s_st = _spawn(c, p, torch.where(can_spawn, s_pix, 0),
                                torch.where(can_spawn, s_spp, 0))
        valid = torch.where(done, can_spawn, p.valid)
        reads = [done.sum(), valid.sum()] + ([p.incl[-1]] if c.adaptive else [])
        st = _where_state(can_spawn, s_st, st)
        _store(p, pix=torch.where(can_spawn, s_pix, p.pix),
               o=torch.where(can_spawn[:, None], s_o, new_o),
               d=torch.where(can_spawn[:, None], s_d, new_d),
               thr=torch.where(can_spawn[:, None], 1.0, new_thr),
               lte=torch.where(donef, 0.0, lte), aov_a=torch.where(donef, 0.0, aov_a),
               aov_n=torch.where(donef, 0.0, aov_n), depth=torch.where(done, 0, depth),
               valid=valid, prev_pdf=prev_pdf, prev_spec=prev_spec,
               n_traces=p.n_traces + n_traces, counter=counter, ctr_pix=ctr_pix,
               ctr_spp=ctr_spp)
        _store(p.st, **{f: getattr(st, f) for f in _LANE_FIELDS})
        reads = torch.stack(reads)
    if c.pool_sort:
        # group coherent outgoing rays, dead lanes last
        (_, pix, o, d, s_n, s_scr, s_dep, s_img, thr, lte, aov_a, aov_n, depth, vi,
         prev_pdf, psp) = yield "pool_sort", (
            p.pix, p.o, p.d, *(getattr(p.st, f) for f in _LANE_FIELDS), p.thr, p.lte,
            p.aov_a, p.aov_n, p.depth, p.valid, p.prev_pdf, p.prev_spec)
        _store(p, pix=pix.to(torch.int64), o=o, d=d, thr=thr, lte=lte, aov_a=aov_a,
               aov_n=aov_n, depth=depth.to(torch.int64), valid=vi != 0, prev_pdf=prev_pdf,
               prev_spec=psp != 0)
        _store(p.st, **{f: x.to(torch.int64) & M32 for f, x in zip(
            _LANE_FIELDS, (s_n, s_scr, s_dep, s_img))})
    return reads


def wavefront_render(
    frame: FrameScene,
    sky: Sky,
    cam: Camera,
    width: int,
    height: int,
    spp: int,
    bsdf_sample: Callable,
    bsdf_eval: Optional[Callable] = None,
    bsdf_pdf: Optional[Callable] = None,
    integrator: str = "pathtrace",
    seed=0,
    lanes: int = 1 << 16,
    max_depth: int = MAX_DEPTH,
    intersect_fn=None,
    occluded_fn=None,
    spp_offset=0,
    pool_key_fn: Optional[Callable] = None,
    light_isect_fn: Optional[Callable] = None,
    pixel_base: int = 0,
    pixel_count: Optional[int] = None,
    mis_single: bool = False,
    sample_counts=None,
    sample_base=None,
    firefly_clamp: float = 0.0,
    light_ris: int = 0,
    sobol: bool = False,
    pool_sort: Callable = bitonic.bitonic_sort,
    max_iters: Optional[int] = None,
    plans: Optional[dict] = None,
) -> WavefrontFilm:
    """Render pixels [pixel_base, pixel_base + pixel_count) of a
    width x height image at `spp` samples with a `lanes`-wide refilling
    pool. Returns per-pixel SUMS (divide by `count`). The CMJ stream and
    the camera rays are keyed on the global pixel id, so a chunked render
    equals an unchunked one. Runs on the device of `frame`.

    `sample_counts` [pixel_count] (optional, adaptive allocation): pixel
    p takes sample_counts[p] samples instead of `spp`, from absolute
    sample index sample_base[p] (default 0) on; the counts sum to at most
    pixel_count * spp. `pool_key_fn(o, d) -> i32 key` re-sorts the lane
    pool after every bounce with `pool_sort` (lanes a power of two, at
    least 1024 on CUDA). `sobol` lets lanes whose seed carries
    SOBOL_SEED_FLAG draw the Sobol sequence. `max_iters` caps the loop's
    iterations (default: enough to drain every sample at full depth); a
    cap that cuts the render leaves the unfinished samples out of the
    film, as the JAX engine's does. `plans` (a dict the caller keeps for
    one frame) keeps the call's plan, its lane buffers and CUDA graphs,
    for the frame's later calls with the same sizes and options."""
    use_nee = integrator in ("nee", "mis")
    use_mis = integrator == "mis"
    mis_single = bool(mis_single) and use_mis
    light_isect = light_isect_fn or intersect_lights
    if use_nee and bsdf_eval is None:
        raise ValueError("nee/mis need bsdf_eval")
    if use_mis and bsdf_pdf is None:
        raise ValueError("mis needs bsdf_pdf")

    device = frame.tri_verts.device
    n_pixels = pixel_count if pixel_count is not None else width * height
    total_samples = n_pixels * spp
    # one-sample MIS paths carry one extra emission-only segment
    depth_cap = max_depth + 1 if mis_single else max_depth
    if max_iters is None:
        # enough bounces to drain everything even if all paths run full depth
        max_iters = (total_samples // lanes + 2) * depth_cap + depth_cap
    assert total_samples < (1 << 31)
    adaptive = sample_counts is not None
    options = (integrator, mis_single, max_depth, float(firefly_clamp), int(light_ris),
               bool(sobol), adaptive, pool_key_fn is not None)
    key = (width, height, spp, n_pixels, lanes) + options
    objs = (frame, sky, cam, bsdf_sample, bsdf_eval, bsdf_pdf)
    graphs = _captures(device)

    def make() -> _Plan:
        c = SimpleNamespace(
            frame=frame, sky=sky, cam=cam, width=width, height=height, spp=spp,
            n_pixels=n_pixels, total_samples=total_samples, n_wraps=lanes // n_pixels + 1,
            max_depth=max_depth, depth_cap=depth_cap, use_nee=use_nee, use_mis=use_mis,
            mis_single=mis_single, ris=use_nee and light_ris >= 2, light_ris=light_ris,
            lights=light_table(frame) if use_nee else None, eps_r=ray_eps(frame),
            firefly_clamp=firefly_clamp, sobol=sobol, adaptive=adaptive,
            pool_sort=pool_key_fn is not None, bsdf_sample=bsdf_sample,
            bsdf_eval=bsdf_eval, bsdf_pdf=bsdf_pdf)

        def buf(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=device)

        i64 = torch.int64
        p = SimpleNamespace(
            pix=buf(lanes, dtype=i64), o=buf(lanes, 3), d=buf(lanes, 3),
            st=CMJState(*(buf(lanes, dtype=i64) for _ in _LANE_FIELDS), sobol=sobol),
            thr=buf(lanes, 3), lte=buf(lanes, 3), aov_a=buf(lanes, 3), aov_n=buf(lanes, 3),
            depth=buf(lanes, dtype=i64), prev_pdf=buf(lanes),
            prev_spec=buf(lanes, dtype=torch.bool), valid=buf(lanes, dtype=torch.bool),
            film=buf(n_pixels, 11), n_traces=buf(dtype=i64),
            counter=buf(dtype=i64), ctr_pix=buf(dtype=i64),
            ctr_spp=buf(dtype=i64), seed=buf(dtype=i64),
            pixel_base=buf(dtype=i64), spp_offset=buf(dtype=i64))
        if adaptive:
            p.incl, p.offs, p.base = (buf(n_pixels, dtype=i64) for _ in range(3))
        return _Plan(c, p, objs, graphs)

    # a kept plan serves only its own frame's objects; the CPU keeps none
    plans = plans if plans is not None and graphs else {}
    if any(not kept.serves(objs) for kept in plans.values()):
        plans.clear()
    if key not in plans:
        plans[key] = make()
    plan = plans[key]
    c, p = plan.c, plan.p

    # this call's values, into the plan's buffers
    p.seed.fill_(int(seed))
    p.pixel_base.fill_(int(pixel_base))
    p.spp_offset.fill_(int(spp_offset))
    ids = torch.arange(lanes, dtype=torch.int64, device=device)
    # the real sample total: the budget, or the adaptive counts' sum, which
    # stays on the device and rides the loop's read-back
    actual_total = total_samples
    if adaptive:
        counts = torch.as_tensor(sample_counts, device=device).to(torch.int64)
        p.incl.copy_(torch.cumsum(counts, dim=0))  # inclusive prefix
        p.offs.copy_(p.incl - counts)
        if sample_base is not None:
            p.base.copy_(torch.as_tensor(sample_base, device=device).to(torch.int64))
        else:
            p.base.zero_()
        pix, spp0 = _sample_at(c, p, ids)
        valid = ids < p.incl[-1]
    else:
        # pixel-major sample order (sample s -> pixel s % P, spp s // P)
        pix, spp0 = ids % n_pixels, ids // n_pixels
        valid = ids < total_samples
    with span("engine.spawn"):
        o, d, st = _spawn(c, p, pix, spp0)
    _store(p, pix=pix, valid=valid, o=o, d=d)
    _store(p.st, **{f: getattr(st, f) for f in _LANE_FIELDS})
    p.thr.fill_(1.0)
    p.prev_pdf.fill_(1.0)
    p.prev_spec.fill_(True)
    p.depth.zero_()
    for x in (p.lte, p.aov_a, p.aov_n, p.film, p.n_traces):
        x.zero_()
    p.counter.fill_(min(lanes, total_samples))  # total samples assigned
    p.ctr_pix.fill_(lanes % n_pixels)  # next sample's pixel (wrap counter)
    p.ctr_spp.fill_(lanes // n_pixels)  # next sample's spp index

    def traced(fn):
        def call(*args):
            with span("engine.trace"):
                out = fn(*args)
            return out if isinstance(out, tuple) else (out,)
        return call

    def sort_pool(pix, o, d, *cols):
        with span("accel.sort"):
            *lane_st, thr, lte, aov_a, aov_n, depth, valid, prev_pdf, prev_spec = cols
            key = torch.where(valid, pool_key_fn(o, d), DEAD_KEY).to(torch.int32)
            return pool_sort(
                key.contiguous(), _as_i32(pix), o.contiguous(), d.contiguous(),
                *(_as_i32(x) for x in lane_st), thr.contiguous(), lte.contiguous(),
                aov_a.contiguous(), aov_n.contiguous(), depth.to(torch.int32),
                valid.to(torch.int32), prev_pdf.contiguous(), prev_spec.to(torch.int32))

    calls = {
        "intersect": traced(intersect_fn or intersect_bruteforce),
        "occluded": traced(occluded_fn or occluded_bruteforce),
        "light_isect": traced(lambda *a: light_isect(frame, *a)),
        "pool_sort": sort_pool,
    }
    counter = min(lanes, total_samples)  # the host's count of samples assigned
    it = 0
    any_valid = total_samples > 0
    slots = lanes_valid = last_valid = 0  # the occupancy counters' host sums
    while it < max_iters and (counter < actual_total or any_valid):
        with span("engine.bounce"):
            reads = _step(plan, calls)
            # the loop's one read-back from the device per iteration
            with span("engine.readback"):
                n_done, n_valid, *total = reads.tolist()
        if total:
            actual_total = total[0]
        # lanes valid in this iteration: its start's count (the first
        # iteration's from the sample total, later ones read back by
        # the iteration before)
        lanes_valid += min(lanes, actual_total) if it == 0 else last_valid
        slots += lanes
        last_valid = n_valid
        any_valid = n_valid > 0
        counter = min(counter + n_done, total_samples)
        it += 1
    timer.count("engine.lane_slots", slots)
    timer.count("engine.lanes_valid", lanes_valid)

    film = p.film.clone()  # the plan's buffer serves the next call
    return WavefrontFilm(
        color=film[:, 0:3],
        albedo=film[:, 3:6],
        normal=film[:, 6:9],
        n_traces=p.n_traces.clone(),
        m2=film[:, 9],
        count=film[:, 10],
    )


def wavefront_pathtrace(
    frame: FrameScene,
    sky: Sky,
    cam: Camera,
    width: int,
    height: int,
    spp: int,
    bsdf_sample: Callable,
    seed=0,
    lanes: int = 1 << 16,
    max_depth: int = MAX_DEPTH,
    intersect_fn=None,
    max_iters: Optional[int] = None,
    spp_offset=0,
    accel=None,
) -> WavefrontFilm:
    """Pathtrace-only wrapper over `wavefront_render` (the JAX engine's
    original entry point, with its signature). Without `intersect_fn` it
    traces as the renderer does: with a binned pack `accel`
    (`pack_binned_np`), the binned intersector inside the bitonic sorted
    wrapper; without one, by brute force, as the JAX engine does."""
    if intersect_fn is None and accel is not None:
        from henjou_torch.accel.sorting import sorted_binned_intersector

        intersect_fn, _ = sorted_binned_intersector(accel)
    return wavefront_render(
        frame, sky, cam, width, height, spp, bsdf_sample,
        integrator="pathtrace", seed=seed, lanes=lanes, max_depth=max_depth,
        intersect_fn=intersect_fn, max_iters=max_iters, spp_offset=spp_offset,
    )
