"""Next-event-estimation integrator, the masked depth-loop form (port of
henjou_tpu/integrator/nee.py; the reference's rt.h:162-281).

Per bounce: an explicit light sample and its shadow ray, then a BSDF
bounce; a direct emitter or sky hit counts only at depth 0
(rt.h:196-208). The reference's unused 2D draw before the BSDF sample
(rt.h:266) is kept, so every lane's stream matches.

Specular (delta) lanes evaluate to exactly 0 towards a light sample, so
their shadow ray is not cast (tmax = 0) and not counted, as in the
wavefront engine; the estimate is the JAX package's, whose count
includes those rays.
"""

from __future__ import annotations

from typing import Callable

import torch

from henjou_torch.bsdf.dispatch import bsdf_eval as default_bsdf_eval
from henjou_torch.bsdf.dispatch import bsdf_sample as default_bsdf_sample
from henjou_torch.integrator.pathtrace import (
    MAX_DEPTH,
    PathtraceResult,
    continue_path,
    init_loop,
    roulette_and_trace,
)
from henjou_torch.integrator.payload import Sky, occluded
from henjou_torch.math.constants import SHADOW_EPS_REL, ray_eps
from henjou_torch.math.vec import absdot, dot, length, local_to_world, orthonormal_basis, world_to_local
from henjou_torch.sampling.cmj import CMJState, cmj_2d
from henjou_torch.sampling.light_sample import light_table, sample_light
from henjou_torch.scene.scenedata import FrameScene
from henjou_torch.utils.timer import span


def light_branch(frame, hit, c, frame_basis, lights, eps_r, occluded_fn):
    """The NEE branch shared by nee and mis: a light sample and its shadow
    ray from the hit, cast only for live non-specular lanes. Returns (st,
    shadow rays cast, ok, g, cos1, l_pdf, l_emission, local_wi_l): `ok`
    marks the lanes whose sample counts, g = cos2 / dist^2."""
    t, n, b = frame_basis
    with span("engine.shade"):
        l_pos, l_normal, l_emission, l_pdf, l_valid, st = sample_light(frame, c.st, lights)
        to_light = l_pos - hit.position
        l_dist = torch.clamp(length(to_light), min=1e-12)
        l_dir = to_light / l_dist[:, None]
        cast = c.alive & ~hit.is_specular
    blocked = occluded(frame, hit.position, l_dir, eps_r,
                       torch.where(cast, l_dist * (1.0 - SHADOW_EPS_REL), 0.0), occluded_fn)
    with span("engine.shade"):
        cos1 = absdot(n, l_dir)
        cos2 = absdot(l_normal, -l_dir)
        local_wi_l = world_to_local(l_dir, t, n, b)
        g = cos2 / (l_dist * l_dist)
        ok = c.alive & l_valid & ~blocked & (l_pdf > 0.0)
    return st, cast.sum(), ok, g, cos1, l_pdf, l_emission, local_wi_l


def bsdf_continuation(hit, c, local_wo, frame_basis, bsdf_sample):
    """The path's next direction (rt.h:262-277, 422-436), after the
    reference's dead 2D draw. Returns the carry moved along it."""
    t, n, b = frame_basis
    _dead, st = cmj_2d(c.st)
    bsdf, local_wi, pdf, st = bsdf_sample(hit, local_wo, st)
    wi = local_to_world(local_wi, t, n, b)
    weight = bsdf * (torch.abs(dot(wi, n)) / torch.clamp(pdf, min=1e-12))[:, None]
    return continue_path(c._replace(st=st), hit, weight, wi)


def emit_first(c, hit, depth: int):
    """Direct emitter or sky radiance, counted only at depth 0; the path
    ends on a miss or a light hit."""
    terminal = (~hit.is_hit) | hit.is_light
    lte = c.lte
    if depth == 0:
        lte = lte + torch.where((c.alive & terminal)[:, None], c.thr * hit.emission, 0.0)
    return c._replace(lte=lte, alive=c.alive & ~terminal)


def nee(
    frame: FrameScene,
    sky: Sky,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    state: CMJState,
    bsdf_sample: Callable = default_bsdf_sample,
    bsdf_eval: Callable = default_bsdf_eval,
    max_depth: int = MAX_DEPTH,
    intersect_fn=None,
    occluded_fn=None,
) -> PathtraceResult:
    eps_r = ray_eps(frame)  # scene-relative tmin
    lights = light_table(frame)
    c = init_loop(ray_o, ray_d, state)
    for depth in range(max_depth):
        with span("engine.bounce"):
            hit, c = roulette_and_trace(frame, sky, c, eps_r, depth, intersect_fn)
            with span("engine.shade"):
                c = emit_first(c, hit, depth)
                n = hit.normal
                t, b = orthonormal_basis(n)
                local_wo = world_to_local(-c.d, t, n, b)

            # ---- NEE (rt.h:218-260) ----
            st, n_shadow, ok, g, cos1, l_pdf, l_emission, local_wi_l = light_branch(
                frame, hit, c, (t, n, b), lights, eps_r, occluded_fn)
            with span("engine.shade"):
                f_l = bsdf_eval(hit, local_wo, local_wi_l)
                contrib = (c.thr * f_l * (g * cos1 / torch.clamp(l_pdf, min=1e-12))[:, None]
                           * l_emission)
                c = c._replace(st=st, n_tr=c.n_tr + n_shadow,
                               lte=c.lte + torch.where(ok[:, None], contrib, 0.0))

                # ---- BSDF bounce ----
                c = bsdf_continuation(hit, c, local_wo, (t, n, b), bsdf_sample)
    return PathtraceResult(lte=c.lte, aov_albedo=c.aov_a, aov_normal=c.aov_n, n_traces=c.n_tr)
