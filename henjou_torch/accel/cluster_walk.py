"""Plain-torch model of the cluster walk of ``csrc/cluster_walk.cuh``.

The four cluster kernels (binned, flat, two-level, matrix form) walk each
ray on RAY_LANES lanes: the top boxes in chunks of RAY_LANES, one per
lane, slab-tested and ballotted, each taken box tested again against the
current best t before its clusters are treated the same way; a visited cluster's K triangles lie
across the lanes, TRIS_PER_LANE consecutive ones per lane; each lane
picks its best candidate and a butterfly of shuffles on (t, k) picks the
cluster's; an any hit takes the lowest lane with a hit and its first k.

The flat kernel's top level is the cluster boxes themselves, one cluster
per top box, visited at once (its one-level form; here the cluster
ballot tests the same box against the same best t, so the visits agree).
The plain versions (`_intersect_plain` of
accel/pallas_binned.py, pallas_cluster.py, pallas_cluster_hbm.py and
pallas_mxu.py) walk cluster by cluster instead. This module
repeats the kernel's steps, vectorised over the rays, so that the CPU
tests can hold the kernel's order bit-equal to them: the same results and
the same (ray, cluster) visits. Nothing but the tests calls it.
"""

from __future__ import annotations

import torch

from henjou_torch.accel import pallas_mxu as pmxu
from henjou_torch.accel.pallas_binned import BinnedClusters, _baldwin
from henjou_torch.accel.pallas_cluster import (
    K,
    PackedClusters,
    _accept,
    _mt,
    _new_best,
    _safe_inv,
    _slab,
)
from henjou_torch.accel.pallas_cluster_hbm import SC, HbmClusters

RAY_LANES = 32  # cluster_walk.cuh's RAY_LANES
TRIS_PER_LANE = K // RAY_LANES


def _pick(tt, uu, vv, ok, any_hit: bool):
    """One cluster's [n, K] candidates through the lanes' picks and the
    reduction across lanes. Returns (hit, t, k, u, v), each [n]."""
    n = tt.shape[0]
    shape = (n, RAY_LANES, TRIS_PER_LANE)
    tt, uu, vv, ok = (x.reshape(shape) for x in (tt, uu, vv, ok))
    lanes = torch.arange(RAY_LANES)
    lt = torch.full((n, RAY_LANES), torch.inf)
    lk = torch.full((n, RAY_LANES), K, dtype=torch.int64)  # K: none
    lu = torch.zeros((n, RAY_LANES))
    lv = torch.zeros((n, RAY_LANES))
    for i in range(TRIS_PER_LANE):  # each lane in ascending k
        ti = tt[:, :, i]
        take = ok[:, :, i] & ((lk == K) if any_hit else (ti < lt))
        lt = torch.where(take, ti, lt)
        lu = torch.where(take, uu[:, :, i], lu)
        lv = torch.where(take, vv[:, :, i], lv)
        lk = torch.where(take, lanes * TRIS_PER_LANE + i, lk)
    has = lk < K
    hit = has.any(dim=1)
    if any_hit:  # the lowest lane of the ballot
        src = torch.argmax(has.to(torch.int32), dim=1)
        t = lt.gather(1, src[:, None])[:, 0]
        k = lk.gather(1, src[:, None])[:, 0]
    else:  # butterfly on (t, k): smaller t, then lower k; u, v stay put
        off = RAY_LANES // 2
        while off:
            ot, ok_k = lt[:, lanes ^ off], lk[:, lanes ^ off]
            take = (ot < lt) | ((ot == lt) & (ok_k < lk))
            lt = torch.where(take, ot, lt)
            lk = torch.where(take, ok_k, lk)
            off //= 2
        if not bool((lk == lk[:, :1]).all()):
            raise AssertionError("the lanes disagree after the butterfly")
        t, k = lt[:, 0], lk[:, 0]
        src = torch.clamp(k // TRIS_PER_LANE, max=RAY_LANES - 1)
    u = lu.gather(1, src[:, None])[:, 0]
    v = lv.gather(1, src[:, None])[:, 0]
    return hit, t, k, u, v


def walk(levels, evaluate, prim_of, any_flag: bool, ray_o, ray_d, tmin, tmax,
         any_hit: bool):
    """The kernel's walk on prepared tmin, tmax [R].

    levels: (top boxes [8, *], number of top boxes, clusters per top box,
    number of clusters walked, cluster boxes [8, *]); evaluate(c, rays,
    best_t[rays]) -> (t, u, v, ok) [n, K] of cluster c; prim_of(c) -> [K]
    ids; any_flag: an any hit reports t = tmin and prim 1. Returns
    ((t, prim, u, v) as the plain versions do, visits)."""
    top, num_top, per_top, num_clusters, aabb = levels
    inv = _safe_inv(ray_d)
    best_t, best_p, best_u, best_v = _new_best(tmax)
    walking = ~(tmax <= tmin)  # a dead ray retires before the walk
    lanes = torch.arange(RAY_LANES)
    visits = 0

    def ballot(box, cols, valid, rays):
        """[n, RAY_LANES]: lane l's slab test of column cols[l]."""
        out = torch.zeros((rays.numel(), RAY_LANES), dtype=torch.bool)
        for lane in lanes[valid].tolist():
            out[:, lane] = _slab(box, int(cols[lane]), ray_o[rays], inv[rays],
                                 tmin[rays], best_t[rays])
        return out

    def retest(box, col, rays, chunk_t):
        """The rays of `rays` whose box `col` still passes against the
        current best t (tested again only where best t moved)."""
        moved = best_t[rays] != chunk_t[rays]
        keep = torch.ones(rays.numel(), dtype=torch.bool)
        if bool(moved.any()):
            keep[moved] = _slab(box, col, ray_o[rays[moved]], inv[rays[moved]],
                                tmin[rays[moved]], best_t[rays[moved]])
        return rays[keep]

    for g0 in range(0, num_top, RAY_LANES):
        rays = torch.nonzero(walking)[:, 0]
        chunk_t = best_t.clone()
        tops = ballot(top, g0 + lanes, g0 + lanes < num_top, rays)
        for b in range(RAY_LANES):
            g = g0 + b
            taken = rays[tops[:, b] & walking[rays]]
            taken = retest(top, g, taken, chunk_t)
            if taken.numel() == 0:
                continue
            for j0 in range(0, per_top, RAY_LANES):
                cols = g * per_top + j0 + lanes
                sub_t = best_t.clone()
                cls = ballot(aabb, cols, (j0 + lanes < per_top) & (cols < num_clusters), taken)
                for bc in range(RAY_LANES):
                    c = int(cols[bc])
                    idx = retest(aabb, c, taken[cls[:, bc] & walking[taken]], sub_t)
                    if idx.numel() == 0:
                        continue
                    visits += idx.numel()
                    hit, t, k, u, v = _pick(*evaluate(c, idx, best_t[idx]), any_hit)
                    h = idx[hit]
                    if any_hit:
                        walking[h] = False
                    if any_hit and any_flag:
                        best_t[h] = tmin[h]
                        best_p[h] = 1
                        continue
                    best_t[h] = t[hit]
                    best_p[h] = prim_of(c)[k[hit]]
                    best_u[h] = u[hit]
                    best_v[h] = v[hit]
    return (best_t, best_p, best_u, best_v), visits


def walk_binned(bc: BinnedClusters, ray_o, ray_d, tmin, tmax, any_hit: bool):
    """binned.cu's walk (`BinnedTest`) on tmin, tmax as `_prepare` in
    accel/pallas_binned.py leaves them."""
    rows = bc.rows.view(-1, 16, K)

    def evaluate(c, idx, bt):
        return _baldwin(rows[c], ray_o[idx], ray_d[idx], tmin[idx], bt)

    levels = (bc.gaabb, bc.num_groups, bc.group, bc.num_clusters, bc.aabb)
    return walk(levels, evaluate, lambda c: rows[c, 12].view(torch.int32), True,
                ray_o, ray_d, tmin, tmax, any_hit)


def walk_hbm(hc: HbmClusters, ray_o, ray_d, tmin, tmax, any_hit: bool):
    """cluster_hbm.cu's walk (`MtTest`): every supercluster slot, padding
    clusters included."""
    rows = hc.rows.view(-1, 16, K)

    def evaluate(c, idx, bt):
        tt, uu, vv, ok = _mt(ray_o[idx], ray_d[idx], *rows[c, :9], tmin[idx], bt)
        return tt, uu, vv, ok & (hc.order[c] >= 0)

    levels = (hc.aabb2, hc.num_super, SC, hc.num_super * SC, hc.aabb)
    return walk(levels, evaluate, lambda c: hc.order[c], False,
                ray_o, ray_d, tmin, tmax, any_hit)


def walk_flat(pc: PackedClusters, ray_o, ray_d, tmin, tmax, any_hit: bool):
    """cluster.cu's walk (`MtTest<SplitPlanes>` on the nine [C, K]
    planes): the C cluster boxes as the top level, one cluster each; the
    padding columns of `aabb` are never reached."""
    planes = pc.planes()

    def evaluate(c, idx, bt):
        tt, uu, vv, ok = _mt(ray_o[idx], ray_d[idx], *(p[c] for p in planes), tmin[idx], bt)
        return tt, uu, vv, ok & (pc.order[c] >= 0)

    levels = (pc.aabb, pc.num_clusters, 1, pc.num_clusters, pc.aabb)
    return walk(levels, evaluate, lambda c: pc.order[c], False,
                ray_o, ray_d, tmin, tmax, any_hit)


def walk_mxu(mc: pmxu.MxuClusters, ray_o, ray_d, tmin, tmax, any_hit: bool):
    """mxu.cu's walk (`MxuTest`): the two-level walk of `walk_hbm`; a visit
    forms each lane's numerators as `_numerators` does, in feature order,
    from the ray's features against its supercluster's centre, then the
    TPU kernel's epilogue."""
    g_blocks = mc.g_rows.view(-1, pmxu.NF, 4 * K)

    def evaluate(c, idx, bt):
        f = pmxu._features(ray_o[idx], ray_d[idx], mc.centers[0:3, c // pmxu.SC])
        det, u_num, v_num, t_num = pmxu._numerators(f, g_blocks[c]).split(K, dim=1)
        det_ok = det.abs() > 1e-12
        inv_det = torch.where(det_ok, 1.0 / det, 0.0)
        tt, uu, vv = t_num * inv_det, u_num * inv_det, v_num * inv_det
        ok = _accept(det_ok, uu, vv, tt, tmin[idx], bt)
        return tt, uu, vv, ok & (mc.order[c] >= 0)

    levels = (mc.aabb2, mc.num_super, pmxu.SC, mc.num_super * pmxu.SC, mc.aabb)
    return walk(levels, evaluate, lambda c: mc.order[c], False,
                ray_o, ray_d, tmin, tmax, any_hit)
