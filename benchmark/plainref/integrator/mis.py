"""Multiple-importance-sampling integrator, the masked depth-loop form
(port of henjou_tpu/integrator/mis.py; the reference's rt.h:284-440).

Three traces per bounce, as in the reference (rt.h:304, 356, 396):

1. the radiance ray (the path's next hit);
2. the NEE shadow ray, weighted light_pdf / (light_pdf + bsdf_pdf * G)
   (rt.h:374-376, the balance heuristic);
3. an independent BSDF-sample ray, traced as a full closest hit, whose
   emitter hit is weighted bsdf_pdf / (bsdf_pdf + light_pdf / G)
   (rt.h:383-420); a miss collects the sky unweighted (rt.h:417-419).

Specular lanes take light_pdf = 0 in branch 3 (rt.h:411) and add nothing
in branch 2 (their eval is 0), so their shadow ray is not cast, as in
nee.py. A direct emitter or sky hit on the radiance ray counts only at
depth 0 (rt.h:318-330). The continuation direction is drawn after
branch 3, with the reference's dead 2D draw (rt.h:426).
"""

from __future__ import annotations

from typing import Callable

import torch

from plainref.bsdf.dispatch import bsdf_eval as default_bsdf_eval
from plainref.bsdf.dispatch import bsdf_pdf as default_bsdf_pdf
from plainref.bsdf.dispatch import bsdf_sample as default_bsdf_sample
from plainref.integrator.nee import bsdf_continuation, emit_first, light_branch
from plainref.integrator.pathtrace import (
    MAX_DEPTH,
    PathtraceResult,
    init_loop,
    roulette_and_trace,
)
from plainref.integrator.payload import Sky, closest_hit
from plainref.math.constants import TMAX_RAY, ray_eps
from plainref.math.vec import absdot, length, local_to_world, orthonormal_basis, world_to_local
from plainref.sampling.cmj import CMJState
from plainref.sampling.light_sample import light_pdf, light_table
from plainref.scene.scenedata import FrameScene


def mis(
    frame: FrameScene,
    sky: Sky,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    state: CMJState,
    bsdf_sample: Callable = default_bsdf_sample,
    bsdf_eval: Callable = default_bsdf_eval,
    bsdf_pdf: Callable = default_bsdf_pdf,
    max_depth: int = MAX_DEPTH,
    intersect_fn=None,
    occluded_fn=None,
) -> PathtraceResult:
    eps_r = ray_eps(frame)  # scene-relative tmin
    lights = light_table(frame)
    c = init_loop(ray_o, ray_d, state)
    for depth in range(max_depth):
        hit, c = roulette_and_trace(frame, sky, c, eps_r, depth, intersect_fn)
        c = emit_first(c, hit, depth)
        n = hit.normal
        t, b = orthonormal_basis(n)
        local_wo = world_to_local(-c.d, t, n, b)

        # ---- NEE branch (rt.h:340-380) ----
        st, n_shadow, ok, g, cos1, l_pdf, l_emission, local_wi_l = light_branch(
            frame, hit, c, (t, n, b), lights, eps_r, occluded_fn)
        f_l = bsdf_eval(hit, local_wo, local_wi_l)
        pt_pdf_l = bsdf_pdf(hit, local_wo, local_wi_l) * g  # rt.h:374
        w_light = l_pdf / torch.clamp(l_pdf + pt_pdf_l, min=1e-12)
        contrib_nee = (
            c.thr * f_l
            * (g * cos1 / torch.clamp(l_pdf, min=1e-12) * w_light)[:, None]
            * l_emission
        )
        lte = c.lte + torch.where(ok[:, None], contrib_nee, 0.0)

        # ---- BSDF-sampling branch (rt.h:382-420) ----
        brdf_b, local_wi_b, pt_pdf_b, st = bsdf_sample(hit, local_wo, st)
        wi_b = local_to_world(local_wi_b, t, n, b)
        cos1_b = absdot(wi_b, n)
        # only live lanes cast it (the JAX package also traces the lanes
        # that ended at this hit, and masks their result)
        lane_tmax = torch.where(c.alive, TMAX_RAY, 0.0)
        hit_b = closest_hit(frame, sky, hit.position, wi_b, eps_r, lane_tmax, intersect_fn)
        cos2_b = absdot(-wi_b, hit_b.normal)
        dist_b = torch.clamp(length(hit_b.position - hit.position), min=1e-12)
        inv_g = dist_b * dist_b / torch.clamp(cos2_b, min=1e-12)
        lp = torch.where(hit.is_specular, 0.0,
                         light_pdf(frame, hit_b.primitive_id, lights) * inv_g)
        w_bsdf = pt_pdf_b / torch.clamp(pt_pdf_b + lp, min=1e-12)
        contrib_hit = (
            c.thr * (w_bsdf * cos1_b / torch.clamp(pt_pdf_b, min=1e-12))[:, None]
            * hit_b.emission * brdf_b
        )
        contrib_miss = (
            c.thr * (cos1_b / torch.clamp(pt_pdf_b, min=1e-12))[:, None]
            * hit_b.emission * brdf_b
        )
        take_hit = c.alive & hit_b.is_hit & hit_b.is_light
        take_miss = c.alive & ~hit_b.is_hit
        lte = lte + torch.where(take_hit[:, None], contrib_hit,
                                torch.where(take_miss[:, None], contrib_miss, 0.0))
        c = c._replace(st=st, lte=lte, n_tr=c.n_tr + n_shadow + c.alive.sum())

        # ---- path continuation (rt.h:422-436) ----
        c = bsdf_continuation(hit, c, local_wo, (t, n, b), bsdf_sample)
    return PathtraceResult(lte=c.lte, aov_albedo=c.aov_a, aov_normal=c.aov_n, n_traces=c.n_tr)
