"""Matrix-form Moller-Trumbore intersector: pack, CUDA kernel, plain
version.

Port of henjou_tpu/accel/pallas_mxu.py. For a ray with features

    F = [d, d x o', o', 1]           (o' = o - centers[:, c2])

and per-triangle 10-vectors G (columns det | u | v | t, recentred per
supercluster and precomputed on the host by `pack_clusters_mxu_np`, the
JAX package's numpy build, unchanged), F . G gives the numerators of det,
u*det, v*det and t*det. The TPU kernel ran them as one [256, 16] x
[16, 512] f32 matmul per cluster on its matrix unit.

`intersect_pallas_mxu` keeps the contract of `intersect_pallas`
(accel/pallas_cluster.py). For CUDA tensors it launches ``csrc/mxu.cu``
(the warp-per-ray cluster walk of ``csrc/cluster_walk.cuh`` over both box
levels, each lane's ten-term dot products in feature order); for CPU
tensors it runs `_intersect_plain`, which sums the same ten terms in the
same order with explicit products and adds, vectorised over the rays:
`torch.matmul` is not used, because its summation order on the card is
unspecified. The two visit the same (ray, cluster) pairs in the same order
and agree to the bit.

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
    _accept,
    _check_pack,
    _dispatch,
    _finish,
    _kept,
    _launch,
    _new_best,
    _prepare,
    _safe_inv,
    _take,
    make_pallas_intersector,
)
from henjou_torch.accel.pallas_cluster_hbm import _expand_bits_np
from henjou_torch.csrc import INT, PTR, bind
from henjou_torch.math.constants import TMAX_RAY

SC = 16  # clusters per supercluster (SC*K = 2048 triangles)
NF = 16  # feature rows (10 used, padded to a sublane multiple)
_NU = 10  # feature rows used

LAUNCHES = 0
VISITS = 0


@dataclasses.dataclass(frozen=True)
class MxuClusters:
    g_rows: torch.Tensor  # [C2*SC*NF, 4K] f32 per-cluster G blocks
    order: torch.Tensor  # [C2*SC, K] i32 original tri ids (-1 padding)
    aabb: torch.Tensor  # [8, Cp]  per-cluster AABBs
    aabb2: torch.Tensor  # [8, C2p] per-supercluster AABBs
    centers: torch.Tensor  # [4, C2p] supercluster recenter points
    num_clusters: int
    num_super: int


def pack_clusters_mxu_np(tri_verts, device) -> MxuClusters:
    """Host numpy build (the JAX package's, unchanged, in float64):
    Morton-order triangles into K-sized clusters, build both AABB levels
    and the per-cluster G matrices, and upload them to `device`."""
    tv = np.asarray(tri_verts, np.float64)
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
    verts = np.zeros((ctot * K, 3, 3), np.float64)
    verts[:t] = tv[order]

    # cluster + supercluster AABBs
    valid = (order_p >= 0).reshape(ctot, K)
    vmin = np.where(valid[..., None, None], verts.reshape(ctot, K, 3, 3), _BIG)
    vmax = np.where(valid[..., None, None], verts.reshape(ctot, K, 3, 3), -_BIG)
    amin = vmin.reshape(ctot, K * 3, 3).min(axis=1)
    amax = vmax.reshape(ctot, K * 3, 3).max(axis=1)
    aabb = np.zeros((8, ctot), np.float32)
    aabb[0:3] = amin.T
    aabb[3:6] = amax.T

    mins = aabb[0:3].reshape(3, c2, SC).min(axis=2)
    maxs = aabb[3:6].reshape(3, c2, SC).max(axis=2)
    c2p = max(8, int(np.ceil(c2 / 8) * 8))
    aabb2 = np.full((8, c2p), _BIG, np.float32)
    aabb2[0:3, :c2] = mins
    aabb2[3:6, :c2] = maxs
    aabb2[3:6, c2:] = -_BIG

    # supercluster recenter points (midpoint of real geometry bounds)
    centers = np.zeros((4, c2p), np.float32)
    finite = np.isfinite(mins) & np.isfinite(maxs) & (mins < _BIG / 2)
    centers[0:3, :c2] = np.where(finite, 0.5 * (mins + maxs), 0.0)

    # ---- G matrices, recentered per supercluster ----
    v0 = verts[:, 0]
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    n = np.cross(e1, e2)
    csc = centers[0:3].T.astype(np.float64)  # [c2p, 3]
    v0p = v0 - np.repeat(csc[:c2], SC * K, axis=0)

    g = np.zeros((ctot * K, NF, 4), np.float64)
    g[:, 0:3, 0] = np.cross(e2, e1)
    g[:, 0:3, 1] = np.cross(v0p, e2)
    g[:, 3:6, 1] = -e2
    g[:, 0:3, 2] = -np.cross(v0p, e1)
    g[:, 3:6, 2] = e1
    g[:, 6:9, 3] = n
    g[:, 9, 3] = -np.einsum("ij,ij->i", v0p, n)

    # [ctot, K, NF, 4] -> [ctot, NF, 4, K] -> rows [ctot*NF, 4K], columns
    # grouped [det(K) | u(K) | v(K) | t(K)]
    g = g.reshape(ctot, K, NF, 4).transpose(0, 2, 3, 1)
    g_rows = np.ascontiguousarray(
        g.reshape(ctot, NF, 4 * K).reshape(ctot * NF, 4 * K), dtype=np.float32
    )

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return MxuClusters(
        g_rows=up(g_rows),
        order=up(order_p.reshape(ctot, K)),
        aabb=up(aabb),
        aabb2=up(aabb2),
        centers=up(centers),
        num_clusters=c,
        num_super=c2,
    )


def _features(o, d, center):
    """F = [d, d x o', o', 1] for rays o, d [n,3] and o' = o - center:
    ten [n] tensors, in feature order."""
    opx = o[:, 0] - center[0]
    opy = o[:, 1] - center[1]
    opz = o[:, 2] - center[2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    return [dx, dy, dz, dy * opz - dz * opy, dz * opx - dx * opz,
            dx * opy - dy * opx, opx, opy, opz, torch.ones_like(dx)]


def _numerators(f, g):
    """The ten-term dot products F . G for [n] features f and a cluster's
    [NF, 4K] block g, summed in feature order 0..9 as mxu.cu does: [n, 4K]."""
    acc = f[0][:, None] * g[0]
    for q in range(1, _NU):
        acc = acc + f[q][:, None] * g[q]
    return acc


def _intersect_plain(mc: MxuClusters, ray_o, ray_d, tmin, tmax, any_hit):
    """Plain PyTorch version of mxu.cu: the two-level walk of the HBM
    kernel; per kept cluster the four numerators as explicit ten-term
    sums, then the TPU kernel's epilogue."""
    global VISITS
    inv = _safe_inv(ray_d)
    best = _new_best(tmax)
    g_blocks = mc.g_rows.view(-1, NF, 4 * K)
    for c2 in range(mc.num_super):
        idx2 = _kept(mc.aabb2, c2, ray_o, inv, tmin, best, any_hit)
        if idx2.numel() == 0:
            continue
        f2 = _features(ray_o[idx2], ray_d[idx2], mc.centers[0:3, c2])
        for j in range(SC):
            c = c2 * SC + j
            keep = _kept(mc.aabb, c, ray_o, inv, tmin, best, any_hit, idx2)
            if keep.numel() == 0:
                continue
            VISITS += keep.numel()
            sel = torch.searchsorted(idx2, keep)  # rows of f2 for `keep`
            out = _numerators([x[sel] for x in f2], g_blocks[c])
            det, u_num, v_num, t_num = out.split(K, dim=1)
            det_ok = det.abs() > 1e-12
            inv_det = torch.where(det_ok, 1.0 / det, 0.0)
            uu = u_num * inv_det
            vv = v_num * inv_det
            tt = t_num * inv_det
            ok = _accept(det_ok, uu, vv, tt, tmin[keep], best[0][keep])
            _take(best, keep, ok, tt, uu, vv, mc.order[c], any_hit)
            if any_hit:
                alive = best[1][idx2] < 0
                idx2 = idx2[alive]
                f2 = [x[alive] for x in f2]
    return best


@functools.cache
def _kernel_fn():
    return bind("henjou_mxu_intersect",
                [PTR, PTR, PTR, INT, PTR, INT, PTR, INT] + RAY_ARGS)


def _intersect_cuda(mc: MxuClusters, ray_o, ray_d, tmin, tmax, any_hit):
    global LAUNCHES
    f32 = torch.float32
    _check_pack(ray_o, g_rows=(mc.g_rows, f32), order=(mc.order, torch.int32),
                aabb=(mc.aabb, f32), aabb2=(mc.aabb2, f32), centers=(mc.centers, f32))
    if mc.g_rows.shape != (mc.num_super * SC * NF, 4 * K) or mc.order.shape != (mc.num_super * SC, K):
        raise ValueError(f"mc.g_rows must be [C2*SC*{NF}, {4 * K}] and mc.order [C2*SC, {K}]")
    if mc.centers.shape[1] != mc.aabb2.shape[1]:
        raise ValueError("mc.centers and mc.aabb2 must have the same columns")
    if mc.g_rows.data_ptr() % 16 or mc.order.data_ptr() % 16:
        raise ValueError("mc.g_rows and mc.order must be 16-byte aligned (the kernel loads "
                         "float4 and int4)")
    args = [mc.g_rows.data_ptr(), mc.order.data_ptr(), mc.aabb.data_ptr(), mc.aabb.shape[1],
            mc.aabb2.data_ptr(), mc.aabb2.shape[1], mc.centers.data_ptr(), mc.num_super]
    out = _launch(_kernel_fn(), "henjou_mxu_intersect", args,
                  ray_o, ray_d, tmin, tmax, any_hit)
    LAUNCHES += 1
    return out


def intersect_pallas_mxu_plain(mc: MxuClusters, ray_o, ray_d, tmin, tmax=TMAX_RAY,
                               any_hit: bool = False):
    """The plain PyTorch version on any device (see `intersect_pallas_mxu`)."""
    tmin, tmax = _prepare(ray_o, ray_d, tmin, tmax, mc.g_rows)
    return _finish(*_intersect_plain(mc, ray_o, ray_d, tmin, tmax, any_hit))


def intersect_pallas_mxu(mc: MxuClusters, ray_o, ray_d, tmin, tmax=TMAX_RAY,
                         any_hit: bool = False):
    """Same contract as accel.bruteforce.intersect_bruteforce. Launches
    ``csrc/mxu.cu`` for CUDA tensors and runs the plain version for CPU
    tensors."""
    return _dispatch(
        lambda *a: _intersect_plain(mc, *a, any_hit),
        lambda *a: _intersect_cuda(mc, *a, any_hit),
        mc.g_rows, ray_o, ray_d, tmin, tmax,
    )


def make_pallas_mxu_intersector(mc: MxuClusters, intersect=intersect_pallas_mxu):
    """(intersect_fn, occluded_fn) over `mc`; `intersect` may be
    `intersect_pallas_mxu_plain`."""
    return make_pallas_intersector(mc, intersect)
