"""Unidirectional path tracer, the masked depth-loop form (port of
henjou_tpu/integrator/pathtrace.py; the reference's `Pathtrace`,
rt.h:85-159).

MAX_DEPTH bounces, Russian roulette on the throughput's largest
component (drawn before the trace, in the reference's stream order),
first-bounce albedo and normal AOVs, emission on a miss or a light hit.

The whole ray batch marches through the depth loop together with an
alive mask: the JAX package's `jax.lax.fori_loop` is a Python loop here,
and no value comes back to the host inside it. Dead lanes trace with
tmax = 0, so the sorted wrapper sinks them and the kernel skips them. The
trace count is an exact int64 (the JAX package sums in f32).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from henjou_torch.bsdf.lambert import lambert_sample
from henjou_torch.integrator.payload import Sky, SurfaceHit, closest_hit
from henjou_torch.math.constants import TMAX_RAY, ray_eps
from henjou_torch.math.vec import dot, local_to_world, orthonormal_basis, world_to_local
from henjou_torch.sampling.cmj import CMJState, cmj_1d
from henjou_torch.scene.scenedata import FrameScene
from henjou_torch.utils.timer import span

MAX_DEPTH = 10  # reference: rt.h:89


def default_bsdf_sample(hit: SurfaceHit, local_wo, state: CMJState):
    """Lambert only (the commented-out baseline of the reference's raygen,
    rt.h:145-149); the renderer passes the full BSDF dispatch."""
    return lambert_sample(hit.basecolor, local_wo, state)


class PathtraceResult(NamedTuple):
    lte: torch.Tensor  # [R,3] radiance estimate
    aov_albedo: torch.Tensor  # [R,3] first-hit basecolor
    aov_normal: torch.Tensor  # [R,3] first-hit shading normal
    # 0-d int64: the traces cast for this batch (radiance per live lane,
    # plus shadow and BSDF-branch rays in nee/mis)
    n_traces: torch.Tensor


class LoopState(NamedTuple):
    """The depth loop's carry, shared by pathtrace, nee and mis."""

    lte: torch.Tensor
    thr: torch.Tensor
    o: torch.Tensor
    d: torch.Tensor
    st: CMJState
    alive: torch.Tensor
    aov_a: torch.Tensor
    aov_n: torch.Tensor
    n_tr: torch.Tensor


def init_loop(ray_o, ray_d, state: CMJState) -> LoopState:
    zero3 = torch.zeros_like(ray_o)
    return LoopState(
        lte=zero3, thr=torch.ones_like(ray_o), o=ray_o, d=ray_d, st=state,
        alive=torch.ones(ray_o.shape[0], dtype=torch.bool, device=ray_o.device),
        aov_a=zero3, aov_n=zero3,
        n_tr=torch.zeros((), dtype=torch.int64, device=ray_o.device),
    )


def roulette_and_trace(frame, sky, c: LoopState, eps_r, depth: int, intersect_fn):
    """The first part of every bounce: Russian roulette, the radiance trace
    of the survivors, and the first-bounce AOVs. Returns (hit, the carry
    with thr, st, alive, aov_a, aov_n and n_tr updated)."""
    u_rr, st = cmj_1d(c.st)
    russian_p = c.thr.amax(dim=-1)
    alive = c.alive & (russian_p >= u_rr)
    thr = c.thr / torch.clamp(russian_p, min=1e-12)[:, None]
    lane_tmax = torch.where(alive, TMAX_RAY, 0.0)
    hit = closest_hit(frame, sky, c.o, c.d, eps_r, lane_tmax, intersect_fn)
    aov_a, aov_n = (hit.basecolor, hit.normal) if depth == 0 else (c.aov_a, c.aov_n)
    return hit, c._replace(thr=thr, st=st, alive=alive, aov_a=aov_a, aov_n=aov_n,
                           n_tr=c.n_tr + alive.sum())


def continue_path(c: LoopState, hit: SurfaceHit, weight, wi) -> LoopState:
    """The last part of every bounce: live lanes take the BSDF weight and
    move to the hit along wi."""
    live = c.alive[:, None]
    return c._replace(thr=torch.where(live, c.thr * weight, c.thr),
                      o=torch.where(live, hit.position, c.o),
                      d=torch.where(live, wi, c.d))


def pathtrace(
    frame: FrameScene,
    sky: Sky,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    state: CMJState,
    bsdf_sample: Callable = default_bsdf_sample,
    max_depth: int = MAX_DEPTH,
    intersect_fn=None,
) -> PathtraceResult:
    eps_r = ray_eps(frame)  # scene-relative tmin
    c = init_loop(ray_o, ray_d, state)
    for depth in range(max_depth):
        with span("engine.bounce"):
            hit, c = roulette_and_trace(frame, sky, c, eps_r, depth, intersect_fn)
            with span("engine.shade"):
                # a miss (sky) or a light hit adds its emission and ends the
                # path (rt.h:118-126)
                terminal = (~hit.is_hit) | hit.is_light
                lte = c.lte + torch.where((c.alive & terminal)[:, None], c.thr * hit.emission,
                                          0.0)
                c = c._replace(lte=lte, alive=c.alive & ~terminal)

                n = hit.normal
                t, b = orthonormal_basis(n)
                local_wo = world_to_local(-c.d, t, n, b)
                bsdf, local_wi, pdf, st = bsdf_sample(hit, local_wo, c.st)
                wi = local_to_world(local_wi, t, n, b)
                weight = bsdf * (torch.abs(dot(wi, n)) / torch.clamp(pdf, min=1e-12))[:, None]
                c = continue_path(c._replace(st=st), hit, weight, wi)
    return PathtraceResult(lte=c.lte, aov_albedo=c.aov_a, aov_normal=c.aov_n, n_traces=c.n_tr)
