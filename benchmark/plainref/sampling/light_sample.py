"""Area-light sampling and the light query of two-sample MIS (port of
henjou_tpu/sampling/light_sample.py: `_light_select_dist`, `sample_light`,
`light_pdf`, `intersect_lights`, `LightAccel`, `build_light_accel` and
`make_binned_light_intersector`).

A light (emissive triangle) is picked by power (luminance x area, the
default) or uniformly (``HENJOU_LIGHT_SAMPLING=uniform``), then a point is
drawn uniformly on it; pdf = selection probability / area. `light_pdf` is
the reverse pdf one-sample MIS needs when a BSDF ray hits a light.

The per-light tables do not change during a frame, so `light_table`
builds them once and the engine passes the result to every bounce (the
JAX package leaves that hoisting to XLA).

Two-sample MIS (``mis_mode="ref"``) asks, per bounce, which light its
BSDF-branch ray would hit: `intersect_lights` answers with dense
Moller-Trumbore against the emissive triangles in chunks of LIGHT_CHUNK,
and `make_binned_light_intersector` with the binned intersector
(``csrc/binned.cu`` on CUDA tensors) over the emissive subset, which the
renderer takes above 512 emissive triangles.

`sample_light_ris` is resampled light selection (``light_ris`` m >= 2 on
the wavefront engine): m candidates from `sample_light`, one kept in
proportion to its unshadowed contribution at the shading point.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from plainref.accel.bruteforce import _mt_chunk
from plainref.math.vec import cross, length, normalize
from plainref.sampling.cmj import CMJState, cmj_1d, cmj_2d
from plainref.scene.scenedata import FrameScene

_LUM = (0.2126, 0.7152, 0.0722)


def light_sampling_strategy() -> str:
    """"power" (default) or "uniform", from HENJOU_LIGHT_SAMPLING."""
    return os.environ.get("HENJOU_LIGHT_SAMPLING", "power")


def _areas(tv: torch.Tensor) -> torch.Tensor:
    return 0.5 * length(cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))


def _light_select_dist(frame: FrameScene):
    """(w_norm[L], cdf[L]) of the power strategy, w_norm summing to 1, or
    None for uniform selection."""
    if light_sampling_strategy() != "power":
        return None
    dev = frame.device
    n_l = int(dev.light_prim_ids.shape[0])
    if n_l == 0:
        return None
    area = _areas(frame.tri_verts[dev.light_prim_ids])
    e = dev.light_prim_emission
    lum = e[:, 0] * _LUM[0] + e[:, 1] * _LUM[1] + e[:, 2] * _LUM[2]
    w = torch.clamp(lum, min=0.0) * torch.clamp(area, min=0.0)
    live = torch.arange(n_l, device=w.device) < dev.num_lights
    w = torch.where(live, w, 0.0)  # padding rows beyond the true count
    total = w.sum()
    # degenerate scenes (all-zero luminance) fall back to uniform
    count = max(float(dev.num_lights), 1.0)
    uniform = torch.where(live, 1.0 / count, 0.0)
    w_norm = torch.where(total > 0.0, w / torch.clamp(total, min=1e-30), uniform)
    return w_norm, torch.cumsum(w_norm, dim=0)


class LightTable(NamedTuple):
    """Per-frame light tables shared by every bounce."""

    dist: Optional[tuple]  # (w_norm[L], cdf[L]) or None for uniform
    verts: torch.Tensor  # [L,3,3] world
    normals: torch.Tensor  # [L,3,3]
    emission: torch.Tensor  # [L,3]
    sel_by_prim: torch.Tensor  # [T] selection probability (0 for non-lights)
    pdf_by_prim: torch.Tensor  # [T] reverse area pdf (0 for non-lights)


def light_selection_prob_by_prim(frame: FrameScene, dist=None) -> torch.Tensor:
    """[T] per-prim selection probability (0 for non-lights)."""
    dev = frame.device
    n_l = int(dev.light_prim_ids.shape[0])
    if dist is None:
        count = max(float(dev.num_lights), 1.0)
        live = torch.arange(n_l, device=frame.tri_verts.device) < dev.num_lights
        p = torch.where(live, 1.0 / count, 0.0)
    else:
        p = dist[0]
    out = torch.zeros(frame.tri_verts.shape[0], dtype=torch.float32,
                      device=frame.tri_verts.device)
    out[dev.light_prim_ids] = p
    return out


def light_table(frame: FrameScene) -> LightTable:
    dev = frame.device
    dist = _light_select_dist(frame)
    sel = light_selection_prob_by_prim(frame, dist)
    return LightTable(
        dist=dist,
        verts=frame.tri_verts[dev.light_prim_ids],
        normals=frame.tri_normals[dev.light_prim_ids],
        emission=dev.light_prim_emission,
        sel_by_prim=sel,
        pdf_by_prim=sel / torch.clamp(_areas(frame.tri_verts), min=1e-12),
    )


def sample_light(frame: FrameScene, state: CMJState, table: Optional[LightTable] = None):
    """Returns (position[R,3], normal[R,3], emission[R,3], pdf[R],
    valid[R], state); valid=False when the scene has no emissive
    triangles."""
    if table is None:
        table = light_table(frame)
    dev = frame.device
    count = float(dev.num_lights)
    p, state = cmj_1d(state)
    r = p.shape[0]
    hi = max(dev.num_lights - 1, 0)
    if table.dist is None:
        idx = torch.clamp((p * count).to(torch.int64), 0, hi)
        sel_p = torch.full((r,), 1.0 / max(count, 1.0), device=p.device)
    else:
        w_norm, cdf = table.dist
        # CDF inversion: the count of cdf entries <= p
        idx = torch.clamp(torch.searchsorted(cdf, p.contiguous(), right=True), 0, hi)
        sel_p = w_norm[idx]
    v = table.verts[idx]  # [R,3,3] world
    n = table.normals[idx]
    emission = table.emission[idx]

    xi, state = cmj_2d(state)
    sq = torch.sqrt(xi[..., 0])
    f1 = (1.0 - sq)[..., None]
    f2 = (sq * (1.0 - xi[..., 1]))[..., None]
    f3 = (sq * xi[..., 1])[..., None]

    position = v[:, 0] * f1 + v[:, 1] * f2 + v[:, 2] * f3
    normal = normalize(n[:, 0] * f1 + n[:, 1] * f2 + n[:, 2] * f3)
    pdf = sel_p / torch.clamp(_areas(v), min=1e-12)
    valid = torch.full((r,), count > 0.5, dtype=torch.bool, device=p.device)
    return position, normal, emission, pdf, valid, state


def light_pdf(frame: FrameScene, prim: torch.Tensor, table: Optional[LightTable] = None):
    """Reverse area pdf of having light-sampled the triangle `prim` [R]."""
    if table is None:
        table = light_table(frame)
    return table.pdf_by_prim[torch.clamp(prim, min=0)]


# dense [R, chunk] block width for intersect_lights: bounds the peak
# intermediate to [R, 512] however many emissive triangles the scene has
LIGHT_CHUNK = 512


def intersect_lights(frame: FrameScene, ray_o, ray_d, tmin, tmax):
    """Closest hit against the EMISSIVE triangles only: dense
    Moller-Trumbore in [R, <=LIGHT_CHUNK] chunks with a running best hit,
    no acceleration structure.

    Returns (t, prim, u, v, hit, area): the intersector contract with the
    global prim id (i32), plus the hit light's triangle area for the MIS
    reverse pdf."""
    dev = frame.device
    n = ray_o.shape[0]
    device = ray_o.device
    t_best = torch.full((n,), torch.inf, device=device)
    u_b = torch.zeros(n, device=device)
    v_b = torch.zeros(n, device=device)
    prim_b = torch.full((n,), -1, dtype=torch.int32, device=device)
    area_b = torch.zeros(n, device=device)
    # light_prim_ids is padded to one row for zero-light scenes: gate on
    # the true count
    n_l = int(dev.light_prim_ids.shape[0]) if dev.num_lights > 0 else 0
    if n_l == 0:
        return t_best, prim_b, u_b, v_b, torch.zeros(n, dtype=torch.bool, device=device), area_b
    lp = dev.light_prim_ids
    tv = frame.tri_verts[lp]  # [L,3,3]
    o = ray_o[:, None, :]
    d = ray_d[:, None, :]
    tmin_b = torch.as_tensor(tmin, dtype=torch.float32, device=device).expand(n)[:, None]
    tmax_b = torch.as_tensor(tmax, dtype=torch.float32, device=device).expand(n)[:, None]
    for c0 in range(0, n_l, LIGHT_CHUNK):
        tvc = tv[c0 : c0 + LIGHT_CHUNK]
        tt, uu, vv, ok = _mt_chunk(o, d, tvc[None, :, 0], tvc[None, :, 1], tvc[None, :, 2],
                                   tmin_b, tmax_b)
        t_c, li = torch.min(torch.where(ok, tt, torch.inf), dim=1)  # first minimum
        better = t_c < t_best
        t_best = torch.where(better, t_c, t_best)
        u_b = torch.where(better, uu.gather(1, li[:, None])[:, 0], u_b)
        v_b = torch.where(better, vv.gather(1, li[:, None])[:, 0], v_b)
        prim_b = torch.where(better, lp[c0:][li].to(torch.int32), prim_b)
        area_b = torch.where(better, _areas(tvc)[li], area_b)
    hit = torch.isfinite(t_best)
    return t_best, torch.where(hit, prim_b, -1), u_b, v_b, hit, area_b
