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

Under a profiler (`utils/timer.py`) each iteration is an `engine.bounce`
span, and the loop counts its lane slots (`engine.lane_slots`, lanes
times iterations) and the valid lanes among them (`engine.lanes_valid`)
from the read-back it already does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from henjou_torch.accel import bitonic
from henjou_torch.accel.sorting import DEAD_KEY
from henjou_torch.integrator.pathtrace import MAX_DEPTH
from henjou_torch.integrator.payload import Sky, closest_hit, occluded
from henjou_torch.math.constants import SHADOW_EPS_REL, TMAX_RAY, ray_eps
from henjou_torch.math.vec import absdot, dot, length, local_to_world, orthonormal_basis, world_to_local
from henjou_torch.runtime.camera import Camera, camera_rays
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
    film, as the JAX engine's does."""
    use_nee = integrator in ("nee", "mis")
    use_mis = integrator == "mis"
    mis_single = bool(mis_single) and use_mis
    light_isect = light_isect_fn or intersect_lights
    if use_nee and bsdf_eval is None:
        raise ValueError("nee/mis need bsdf_eval")
    if use_mis and bsdf_pdf is None:
        raise ValueError("mis needs bsdf_pdf")

    device = frame.tri_verts.device
    eps_r = ray_eps(frame)  # scene-relative tmin
    lights = light_table(frame) if use_nee else None
    ris = use_nee and light_ris >= 2
    n_pixels = pixel_count if pixel_count is not None else width * height
    total_samples = n_pixels * spp
    # one-sample MIS paths carry one extra emission-only segment
    depth_cap = max_depth + 1 if mis_single else max_depth
    if max_iters is None:
        # enough bounces to drain everything even if all paths run full depth
        max_iters = (total_samples // lanes + 2) * depth_cap + depth_cap
    assert total_samples < (1 << 31)
    n_wraps = lanes // n_pixels + 1
    spp_offset = int(spp_offset)
    pixel_base = int(pixel_base)

    def spawn(pix, spp_idx):
        """(chunk-local pixel, spp) -> fresh path state, keyed on the
        global pixel id."""
        gpix = pix + pixel_base
        st = make_cmj_state(spp_idx + spp_offset, gpix, seed, sobol=sobol)
        return camera_rays(cam, width, height, gpix, st)

    ids = torch.arange(lanes, dtype=torch.int64, device=device)
    adaptive = sample_counts is not None
    # the real sample total: the budget, or the adaptive counts' sum, which
    # stays on the device and rides the loop's read-back
    actual_total = total_samples
    if adaptive:
        counts = torch.as_tensor(sample_counts, device=device).to(torch.int64)
        incl = torch.cumsum(counts, dim=0)  # inclusive prefix
        offs = incl - counts
        base = (torch.as_tensor(sample_base, device=device).to(torch.int64)
                if sample_base is not None else torch.zeros_like(counts))
        actual_total_dev = incl[-1]

        def sample_at(s_idx):
            """sample index -> (chunk-local pixel, absolute spp index);
            callers gate on s_idx < the counts' sum."""
            p = torch.clamp(torch.searchsorted(incl, s_idx, right=True), max=n_pixels - 1)
            return p, torch.clamp(base[p] + s_idx - offs[p], min=0)

        pix, spp0 = sample_at(ids)
        valid = ids < actual_total_dev
    else:
        # pixel-major sample order (sample s -> pixel s % P, spp s // P)
        pix, spp0 = ids % n_pixels, ids // n_pixels
        valid = ids < total_samples
    with span("engine.spawn"):
        o, d, st = spawn(pix, spp0)

    film = torch.zeros((n_pixels, 11), dtype=torch.float32, device=device)
    n_traces = torch.zeros((), dtype=torch.int64, device=device)
    counter = min(lanes, total_samples)  # total samples assigned
    ctr_pix = lanes % n_pixels  # next sample's pixel (wrap counter)
    ctr_spp = lanes // n_pixels  # next sample's spp index
    thr = torch.ones((lanes, 3), dtype=torch.float32, device=device)
    lte = torch.zeros((lanes, 3), dtype=torch.float32, device=device)
    aov_a = torch.zeros_like(lte)
    aov_n = torch.zeros_like(lte)
    depth = torch.zeros(lanes, dtype=torch.int64, device=device)
    prev_pdf = torch.ones(lanes, dtype=torch.float32, device=device)
    prev_spec = torch.ones(lanes, dtype=torch.bool, device=device)

    it = 0
    any_valid = total_samples > 0
    slots = lanes_valid = last_valid = 0  # the occupancy counters' host sums
    while it < max_iters and (counter < actual_total or any_valid):
        with span("engine.bounce"):
            # ---- Russian roulette (the draw precedes the trace) ----
            u_rr, st = cmj_1d(st)
            russian_p = thr.amax(dim=-1)
            survive = russian_p >= u_rr
            thr = thr / torch.clamp(russian_p, min=1e-12)[:, None]
            alive = valid & survive

            # ---- radiance trace ----
            lane_tmax = torch.where(alive, TMAX_RAY, 0.0)
            hit = closest_hit(frame, sky, o, d, eps_r, lane_tmax, intersect_fn)
            n_traces = n_traces + alive.sum()

            with span("engine.shade"):
                first = depth == 0
                aov_a = torch.where(first[:, None], hit.basecolor, aov_a)
                aov_n = torch.where(first[:, None], hit.normal, aov_n)

                terminal = (~hit.is_hit) | hit.is_light
                if mis_single:
                    # terminal emission at every depth, balance-weighted
                    # against the reverse light pdf of the prim the previous
                    # bounce's BSDF draw hit (sky misses have lp = 0 ->
                    # weight 1)
                    lp_area = lights.pdf_by_prim[hit.primitive_id]
                    dist2 = torch.clamp(hit.t * hit.t, min=1e-24)
                    cos2 = absdot(d, hit.normal)
                    lp = torch.where(hit.is_light,
                                     lp_area * dist2 / torch.clamp(cos2, min=1e-12), 0.0)
                    w_emit = torch.where(
                        first | prev_spec, 1.0, prev_pdf / torch.clamp(prev_pdf + lp, min=1e-12)
                    )
                    emit_gate = alive & terminal
                    lte = lte + torch.where(emit_gate[:, None],
                                            thr * hit.emission * w_emit[:, None], 0.0)
                else:
                    # with NEE, direct emitter/sky only at depth 0
                    emit_gate = alive & terminal & first if use_nee else alive & terminal
                    lte = lte + torch.where(emit_gate[:, None], thr * hit.emission, 0.0)
                alive = alive & ~terminal
                # the emission-only segment does no NEE and no continuation
                emit_seg = depth >= max_depth if mis_single else torch.zeros_like(alive)

                n = hit.normal
                t, b = orthonormal_basis(n)
                local_wo = world_to_local(-d, t, n, b)

            if use_nee:
                # ---- NEE shadow branch ----
                with span("engine.shade"):
                    if ris:
                        # l_pdf_eff divides the contribution, l_pdf weighs MIS
                        (l_pos, l_normal, l_emission, l_pdf_eff, l_pdf, l_valid,
                         st) = sample_light_ris(frame, st, hit.position, n, light_ris, lights)
                    else:
                        l_pos, l_normal, l_emission, l_pdf, l_valid, st = sample_light(
                            frame, st, lights)
                        l_pdf_eff = l_pdf
                    to_light = l_pos - hit.position
                    l_dist = torch.clamp(length(to_light), min=1e-12)
                    l_dir = to_light / l_dist[:, None]
                    # specular lanes contribute exactly 0 to NEE: their
                    # shadow rays are zero-width, so the sort sinks them and
                    # the kernel skips
                    nee_live = alive & ~hit.is_specular & ~emit_seg
                shadow_blocked = occluded(
                    frame, hit.position, l_dir, eps_r,
                    torch.where(nee_live, l_dist * (1.0 - SHADOW_EPS_REL), 0.0),
                    occluded_fn,
                )
                n_traces = n_traces + nee_live.sum()
                with span("engine.shade"):
                    cos1 = absdot(n, l_dir)
                    cos2 = absdot(l_normal, -l_dir)
                    local_wi_l = world_to_local(l_dir, t, n, b)
                    f_l = bsdf_eval(hit, local_wo, local_wi_l)
                    g = cos2 / (l_dist * l_dist)
                    if use_mis:
                        pt_pdf_l = bsdf_pdf(hit, local_wo, local_wi_l) * g
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

            if use_mis and not mis_single:
                # ---- independent BSDF-branch trace (the two-sample form) ----
                # Its hit is only used when it is a light or a miss: a
                # closest hit against the emissive triangles, then a bounded
                # any-hit query up to that light (or the scene exit), then
                # the payload fill fed the synthesized result, so textured
                # lights shade as in a full trace.
                with span("engine.shade"):
                    brdf_b, local_wi_b, pt_pdf_b, st = bsdf_sample(hit, local_wo, st)
                    wi_b = local_to_world(local_wi_b, t, n, b)
                    cos1_b = absdot(wi_b, n)
                    lane_tmax_b = torch.where(alive, TMAX_RAY, 0.0)
                with span("engine.trace"):
                    t_l, prim_l, u_l, v_l, hit_l, area_l = light_isect(
                        frame, hit.position, wi_b, eps_r, lane_tmax_b
                    )
                blocked_b = occluded(
                    frame, hit.position, wi_b, eps_r,
                    torch.where(hit_l, t_l * (1.0 - SHADOW_EPS_REL), lane_tmax_b),
                    occluded_fn,
                )
                vis_l = hit_l & ~blocked_b

                def synthesized(tri, o_, d_, tn, tx):
                    return (torch.where(vis_l, t_l, torch.inf), torch.where(vis_l, prim_l, -1),
                            u_l, v_l, vis_l)

                hit_b = closest_hit(frame, sky, hit.position, wi_b, eps_r, lane_tmax_b,
                                    synthesized)
                n_traces = n_traces + alive.sum()
                with span("engine.shade"):
                    cos2_b = absdot(-wi_b, hit_b.normal)
                    dist_b = torch.clamp(length(hit_b.position - hit.position), min=1e-12)
                    inv_g = dist_b * dist_b / torch.clamp(cos2_b, min=1e-12)
                    # reverse light pdf: selection probability of the prim
                    # hit over its area
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
                if use_nee:
                    _dead, st = cmj_2d(st)  # the reference's dead 2D draw, kept for parity
                bsdf, local_wi, pdf, st = bsdf_sample(hit, local_wo, st)
                wi = local_to_world(local_wi, t, n, b)
                weight = bsdf * (torch.abs(dot(wi, n)) / torch.clamp(pdf, min=1e-12))[:, None]

                depth = depth + 1
                done = valid & (~survive | terminal | (depth >= depth_cap))
                continuing = valid & ~done

                new_thr = torch.where(continuing[:, None], thr * weight, thr)
                new_o = torch.where(continuing[:, None], hit.position, o)
                new_d = torch.where(continuing[:, None], wi, d)
                if mis_single:
                    prev_pdf = torch.where(continuing, pdf, prev_pdf)
                    prev_spec = torch.where(continuing, hit.is_specular, prev_spec)

            # ---- film accumulation for finished lanes (one packed scatter) ----
            with span("engine.film"):
                donef = done[:, None]
                lum = lte[:, 0] * _LUMA[0] + lte[:, 1] * _LUMA[1] + lte[:, 2] * _LUMA[2]
                lte_acc = lte
                if firefly_clamp > 0.0:
                    scale = torch.clamp(firefly_clamp / torch.clamp(lum, min=1e-12), max=1.0)
                    lte_acc = lte * scale[:, None]
                    lum = lum * scale
                packed = torch.where(
                    donef,
                    torch.cat([lte_acc, aov_a, aov_n, (lum * lum)[:, None],
                               torch.ones_like(lum)[:, None]], dim=1),
                    0.0,
                )
                film.index_add_(0, pix, packed)

            # ---- refill finished lanes with fresh samples ----
            with span("engine.spawn"):
                rank = torch.cumsum(done.to(torch.int64), dim=0) - 1
                if adaptive:
                    # the monotonic counter indexes the sample list
                    s_idx = counter + rank
                    can_spawn = done & (s_idx < actual_total_dev)
                    s_pix, s_spp = sample_at(s_idx)
                else:
                    # (pixel, spp) wrap-counter arithmetic
                    s_pix = ctr_pix + rank
                    s_spp = torch.full_like(s_pix, ctr_spp)
                    for _ in range(n_wraps):
                        wrap = s_pix >= n_pixels
                        s_pix = s_pix - torch.where(wrap, n_pixels, 0)
                        s_spp = s_spp + wrap.to(torch.int64)
                    can_spawn = done & (s_spp < spp)
                s_o, s_d, s_st = spawn(torch.where(can_spawn, s_pix, 0),
                                       torch.where(can_spawn, s_spp, 0))

                pix = torch.where(can_spawn, s_pix, pix)
                o = torch.where(can_spawn[:, None], s_o, new_o)
                d = torch.where(can_spawn[:, None], s_d, new_d)
                st = _where_state(can_spawn, s_st, st)
                thr = torch.where(can_spawn[:, None], 1.0, new_thr)
                lte = torch.where(donef, 0.0, lte)
                aov_a = torch.where(donef, 0.0, aov_a)
                aov_n = torch.where(donef, 0.0, aov_n)
                depth = torch.where(done, 0, depth)
                valid = torch.where(done, can_spawn, valid)
            if pool_key_fn is not None:
                # group coherent outgoing rays, dead lanes last
                with span("accel.sort"):
                    key = torch.where(valid, pool_key_fn(o, d), DEAD_KEY).to(torch.int32)
                    (_, pix, o, d, s_n, s_scr, s_dep, s_img, thr, lte, aov_a, aov_n, depth, vi,
                     prev_pdf, psp) = pool_sort(
                        key.contiguous(), _as_i32(pix), o.contiguous(), d.contiguous(),
                        *(_as_i32(getattr(st, f)) for f in _LANE_FIELDS),
                        thr.contiguous(), lte.contiguous(), aov_a.contiguous(),
                        aov_n.contiguous(), depth.to(torch.int32), valid.to(torch.int32),
                        prev_pdf.contiguous(), prev_spec.to(torch.int32))
                    pix, depth = pix.to(torch.int64), depth.to(torch.int64)
                    st = st._replace(**{f: x.to(torch.int64) & M32 for f, x in zip(
                        _LANE_FIELDS, (s_n, s_scr, s_dep, s_img))})
                    valid, prev_spec = vi != 0, psp != 0
            # the loop's one read-back from the device per iteration
            with span("engine.readback"):
                reads = [done.sum(), valid.sum()] + ([actual_total_dev] if adaptive else [])
                n_done, n_valid, *total = torch.stack(reads).tolist()
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
            ctr_pix += n_done
            for _ in range(n_wraps):
                if ctr_pix >= n_pixels:
                    ctr_pix -= n_pixels
                    ctr_spp += 1
            it += 1
    timer.count("engine.lane_slots", slots)
    timer.count("engine.lanes_valid", lanes_valid)

    return WavefrontFilm(
        color=film[:, 0:3],
        albedo=film[:, 3:6],
        normal=film[:, 6:9],
        n_traces=n_traces,
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
