"""Two-level cluster intersector: packs, CUDA kernel, plain version.

Port of henjou_tpu/accel/pallas_cluster_hbm.py. Clusters of K = 128
triangles group into superclusters of SC = 16; `rows` holds each
cluster's nine component planes (v0 | e1 | e2, padded to 16 rows), with
the original ids in `order` and the two AABB levels in `aabb` and
`aabb2`. `pack_clusters_hbm` builds it on tensors from
`pallas_cluster.pack_clusters`; `pack_clusters_hbm_np` is the JAX
package's numpy build, unchanged, uploaded to a device. Both equal the
JAX packs field for field.

`intersect_pallas_hbm` keeps the contract of `intersect_pallas`
(accel/pallas_cluster.py), with no clamp of tmin or tmax. For CUDA tensors
it launches ``csrc/cluster_hbm.cu``, the cluster walk of
``csrc/cluster_walk.cuh`` (a warp per ray: superclusters, then their
clusters, in index order, each slab-tested against the ray's [tmin,
best_t]; a cluster's 128 triangles across the lanes); for CPU tensors it
runs `_intersect_plain`, the same walk vectorised over the rays, which
agrees with the kernel to the bit. `accel/cluster_walk.py` models the
kernel's own order for the tests.
The TPU kernel's per-tile frustum pre-pass and far plane are not ported:
for one ray its own slab test subsumes both.

``LAUNCHES`` counts the wrapper calls that launched the CUDA kernel;
``VISITS`` the (ray, cluster) pairs the plain version tested triangles
for, the work that chip_smoke.py's bound counts.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from henjou_torch.accel.pallas_cluster import (
    _BIG,
    K,
    RAY_ARGS,
    _check_pack,
    _dispatch,
    _finish,
    _kept,
    _launch,
    _mt,
    _new_best,
    _prepare,
    _safe_inv,
    _take,
    make_pallas_intersector,
    pack_clusters,
)
from henjou_torch.csrc import INT, PTR, bind
from henjou_torch.math.constants import TMAX_RAY

SC = 16  # clusters per supercluster (SC*K = 2048 triangles)

LAUNCHES = 0
VISITS = 0


@dataclasses.dataclass(frozen=True)
class HbmClusters:
    rows: torch.Tensor  # [C2*SC*16, K] f32 (9 used + 7 pad planes per cluster)
    order: torch.Tensor  # [C2*SC, K] i32 original tri ids (-1 padding)
    aabb: torch.Tensor  # [8, Cp]  per-cluster AABBs (padded never-hit)
    aabb2: torch.Tensor  # [8, C2p] per-supercluster AABBs
    num_clusters: int
    num_super: int


def pack_clusters_hbm(tri_verts: torch.Tensor) -> HbmClusters:
    """The two-level pack on the device of `tri_verts`."""
    pc = pack_clusters(tri_verts)
    dev = tri_verts.device
    c = pc.num_clusters
    c2 = (c + SC - 1) // SC
    cpad = c2 * SC - c

    rows = torch.stack(pc.planes(), dim=1)  # [C, 9, K]
    order = pc.order
    if cpad:
        rows = torch.cat([rows, torch.zeros((cpad, 9, K), device=dev)])
        order = torch.cat([order, torch.full((cpad, K), -1, dtype=torch.int32, device=dev)])
    # 9 -> 16 planes per cluster (the TPU's DMA wanted sublane multiples)
    rows = torch.cat([rows, torch.zeros((rows.shape[0], 7, K), device=dev)], dim=1)
    rows = rows.reshape(-1, K).contiguous()  # [C*16, K]

    # cluster AABBs padded out to the supercluster multiple (never hit)
    need = c2 * SC
    aabb = pc.aabb
    if aabb.shape[1] < need:
        extra = torch.full((8, need - aabb.shape[1]), _BIG, device=dev)
        extra[3:6] = -_BIG
        aabb = torch.cat([aabb, extra], dim=1)

    # supercluster AABBs: union over each SC-block of cluster AABBs
    mins = aabb[0:3, :need].reshape(3, c2, SC).amin(dim=2)
    maxs = aabb[3:6, :need].reshape(3, c2, SC).amax(dim=2)
    c2p = max(8, -(-c2 // 8) * 8)
    aabb2 = torch.full((8, c2p), _BIG, device=dev)
    aabb2[0:3, :c2] = mins
    aabb2[3:6, :c2] = maxs
    aabb2[3:6, c2:] = -_BIG

    return HbmClusters(rows=rows, order=order.contiguous(), aabb=aabb.contiguous(),
                       aabb2=aabb2, num_clusters=c, num_super=c2)


def _expand_bits_np(v):
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def pack_clusters_hbm_np(tri_verts, device) -> HbmClusters:
    """Host numpy build (the JAX package's, unchanged), uploaded to
    `device`."""
    tv = np.asarray(tri_verts, np.float32)
    t = tv.shape[0]
    centroids = tv.mean(axis=1)
    lo = tv.reshape(-1, 3).min(axis=0)
    hi = tv.reshape(-1, 3).max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    q = np.clip((centroids - lo) / extent, 0.0, 1.0 - 1e-7)
    scaled = np.minimum((q * 1024).astype(np.uint32), np.uint32(1023))
    with np.errstate(over="ignore"):
        codes = (
            (_expand_bits_np(scaled[:, 0]) << np.uint32(2))
            | (_expand_bits_np(scaled[:, 1]) << np.uint32(1))
            | _expand_bits_np(scaled[:, 2])
        )
    order = np.argsort(codes, kind="stable").astype(np.int32)

    pad = (-t) % K
    c = (t + pad) // K
    c2 = (c + SC - 1) // SC
    ctot = c2 * SC

    order_p = np.full(ctot * K, -1, np.int32)
    order_p[:t] = order
    verts = np.zeros((ctot * K, 3, 3), np.float32)
    verts[:t] = tv[order]

    v0 = verts[:, 0]
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]

    valid = (order_p >= 0).reshape(ctot, K)
    vmin = np.where(valid[..., None, None], verts.reshape(ctot, K, 3, 3), _BIG)
    vmax = np.where(valid[..., None, None], verts.reshape(ctot, K, 3, 3), -_BIG)
    amin = vmin.reshape(ctot, K * 3, 3).min(axis=1)
    amax = vmax.reshape(ctot, K * 3, 3).max(axis=1)

    aabb = np.empty((8, ctot), np.float32)
    aabb[0:3] = amin.T
    aabb[3:6] = amax.T
    aabb[6:8] = 0.0

    mins = aabb[0:3].reshape(3, c2, SC).min(axis=2)
    maxs = aabb[3:6].reshape(3, c2, SC).max(axis=2)
    c2p = max(8, int(np.ceil(c2 / 8) * 8))
    aabb2 = np.full((8, c2p), _BIG, np.float32)
    aabb2[0:3, :c2] = mins
    aabb2[3:6, :c2] = maxs
    aabb2[3:6, c2:] = -_BIG

    rows = np.zeros((ctot, 16, K), np.float32)
    comps = [v0[:, 0], v0[:, 1], v0[:, 2], e1[:, 0], e1[:, 1], e1[:, 2],
             e2[:, 0], e2[:, 1], e2[:, 2]]
    for i, comp in enumerate(comps):
        rows[:, i, :] = comp.reshape(ctot, K)
    rows = rows.reshape(-1, K)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return HbmClusters(
        rows=up(rows),
        order=up(order_p.reshape(ctot, K)),
        aabb=up(aabb),
        aabb2=up(aabb2),
        num_clusters=c,
        num_super=c2,
    )


def _intersect_plain(hc: HbmClusters, ray_o, ray_d, tmin, tmax, any_hit):
    """Plain PyTorch version of cluster_hbm.cu: superclusters, then their
    clusters, in index order, with per-ray slab culls against
    [tmin, best_t]; Moller-Trumbore of the kept rays against each kept
    cluster's K triangles."""
    global VISITS
    inv = _safe_inv(ray_d)
    best = _new_best(tmax)
    rows = hc.rows.view(-1, 16, K)
    for c2 in range(hc.num_super):
        idx2 = _kept(hc.aabb2, c2, ray_o, inv, tmin, best, any_hit)
        if idx2.numel() == 0:
            continue
        for j in range(SC):
            c = c2 * SC + j
            idx = _kept(hc.aabb, c, ray_o, inv, tmin, best, any_hit, idx2)
            if idx.numel() == 0:
                continue
            VISITS += idx.numel()
            tt, uu, vv, ok = _mt(ray_o[idx], ray_d[idx], *rows[c, :9],
                                 tmin[idx], best[0][idx])
            _take(best, idx, ok, tt, uu, vv, hc.order[c], any_hit)
            if any_hit:
                idx2 = idx2[best[1][idx2] < 0]
    return best


@functools.cache
def _kernel_fn():
    return bind("henjou_cluster_hbm_intersect",
                [PTR, PTR, PTR, INT, PTR, INT, INT] + RAY_ARGS)


def _intersect_cuda(hc: HbmClusters, ray_o, ray_d, tmin, tmax, any_hit):
    global LAUNCHES
    f32 = torch.float32
    _check_pack(ray_o, rows=(hc.rows, f32), order=(hc.order, torch.int32),
                aabb=(hc.aabb, f32), aabb2=(hc.aabb2, f32))
    if hc.rows.shape != (hc.num_super * SC * 16, K) or hc.order.shape != (hc.num_super * SC, K):
        raise ValueError(f"hc.rows must be [C2*SC*16, {K}] and hc.order [C2*SC, {K}]")
    if hc.rows.data_ptr() % 16 or hc.order.data_ptr() % 16:
        raise ValueError("hc.rows and hc.order must be 16-byte aligned (the kernel loads "
                         "float4 and int4)")
    args = [hc.rows.data_ptr(), hc.order.data_ptr(), hc.aabb.data_ptr(), hc.aabb.shape[1],
            hc.aabb2.data_ptr(), hc.aabb2.shape[1], hc.num_super]
    out = _launch(_kernel_fn(), "henjou_cluster_hbm_intersect", args,
                  ray_o, ray_d, tmin, tmax, any_hit)
    LAUNCHES += 1
    return out


def intersect_pallas_hbm_plain(hc: HbmClusters, ray_o, ray_d, tmin, tmax=TMAX_RAY,
                               any_hit: bool = False):
    """The plain PyTorch version on any device (see `intersect_pallas_hbm`)."""
    tmin, tmax = _prepare(ray_o, ray_d, tmin, tmax, hc.rows)
    return _finish(*_intersect_plain(hc, ray_o, ray_d, tmin, tmax, any_hit))


def intersect_pallas_hbm(hc: HbmClusters, ray_o, ray_d, tmin, tmax=TMAX_RAY,
                         any_hit: bool = False):
    """Same contract as accel.bruteforce.intersect_bruteforce. Launches
    ``csrc/cluster_hbm.cu`` for CUDA tensors and runs the plain version
    for CPU tensors."""
    return _dispatch(
        lambda *a: _intersect_plain(hc, *a, any_hit),
        lambda *a: _intersect_cuda(hc, *a, any_hit),
        hc.rows, ray_o, ray_d, tmin, tmax,
    )


def make_pallas_hbm_intersector(hc: HbmClusters, intersect=intersect_pallas_hbm):
    """(intersect_fn, occluded_fn) over `hc`; `intersect` may be
    `intersect_pallas_hbm_plain`."""
    return make_pallas_intersector(hc, intersect)
