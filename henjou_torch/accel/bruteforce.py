"""Brute-force all-triangles intersector (port of
henjou_tpu/accel/bruteforce.py).

Möller-Trumbore against every triangle, in chunks of TRI_CHUNK triangles
with a running best hit, so peak memory is O(R * TRI_CHUNK). It is the
production path for scenes of BRUTE_FORCE_MAX_TRIS triangles or fewer
(`runtime/scene_accel.py`) and the oracle the binned intersector is
tested against.
"""

from __future__ import annotations

import torch

from henjou_torch.math.constants import TMAX_RAY
from henjou_torch.math.vec import cross, dot

TRI_CHUNK = 256
_DET_EPS = 1e-12


def _mt_chunk(ray_o, ray_d, v0, v1, v2, tmin, tmax):
    """Möller-Trumbore for [R,1,3] rays against [1,C,3] triangles. Returns
    (t, u, v, valid) each [R,C]. No backface culling."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(ray_d, e2)
    det = dot(e1, pvec)
    inv_det = torch.where(torch.abs(det) > _DET_EPS, 1.0 / det, 0.0)
    tvec = ray_o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(ray_d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (
        (torch.abs(det) > _DET_EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin)
        & (t < tmax)
    )
    return t, u, v, valid


def _bounds(ray_o, tmin, tmax):
    r = ray_o.shape[0]
    dev = ray_o.device
    tmin = torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(r)
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(r)
    return tmin[:, None], tmax[:, None]


def intersect_bruteforce(tri_verts, ray_o, ray_d, tmin, tmax=TMAX_RAY):
    """Closest-hit query. Returns (hit_t[R], prim_id[R] i32, u[R], v[R],
    is_hit[R]); prim_id == -1 and t == inf on a miss."""
    r = ray_o.shape[0]
    dev = ray_o.device
    tmin_c, tmax_c = _bounds(ray_o, tmin, tmax)
    ro = ray_o[:, None, :]
    rd = ray_d[:, None, :]
    best_t = torch.full((r,), torch.inf, device=dev)
    best_i = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(r, device=dev)
    best_v = torch.zeros(r, device=dev)
    for base in range(0, tri_verts.shape[0], TRI_CHUNK):
        chunk = tri_verts[base : base + TRI_CHUNK]
        t, u, v, valid = _mt_chunk(
            ro, rd, chunk[None, :, 0], chunk[None, :, 1], chunk[None, :, 2],
            tmin_c, tmax_c,
        )
        t = torch.where(valid, t, torch.inf)
        cand_t, arg = torch.min(t, dim=1)
        closer = cand_t < best_t
        best_u = torch.where(closer, u.gather(1, arg[:, None])[:, 0], best_u)
        best_v = torch.where(closer, v.gather(1, arg[:, None])[:, 0], best_v)
        best_i = torch.where(closer, (arg + base).to(torch.int32), best_i)
        best_t = torch.where(closer, cand_t, best_t)
    return best_t, best_i, best_u, best_v, best_i >= 0


def occluded_bruteforce(tri_verts, ray_o, ray_d, tmin, tmax):
    """Any-hit query for shadow rays. Returns bool [R]."""
    r = ray_o.shape[0]
    tmin_c, tmax_c = _bounds(ray_o, tmin, tmax)
    ro = ray_o[:, None, :]
    rd = ray_d[:, None, :]
    blocked = torch.zeros(r, dtype=torch.bool, device=ray_o.device)
    for base in range(0, tri_verts.shape[0], TRI_CHUNK):
        chunk = tri_verts[base : base + TRI_CHUNK]
        _, _, _, valid = _mt_chunk(
            ro, rd, chunk[None, :, 0], chunk[None, :, 1], chunk[None, :, 2],
            tmin_c, tmax_c,
        )
        blocked |= valid.any(dim=1)
    return blocked
