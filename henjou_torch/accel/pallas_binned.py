"""Binned cluster intersector: host pack, CUDA kernel, plain version.

Port of henjou_tpu/accel/pallas_binned.py. The host pack is the JAX
package's numpy code unchanged (`_median_split_order`, `_baldwin_rows_np`,
`pack_binned_np`), so `rows`, `aabb` and `gaabb` are equal to the
reference's. `intersect_binned` keeps the reference's contract:

    (t or inf, prim or -1, u, v, hit)

for closest hits, and with ``any_hit=True`` a hit flag per ray (hit lanes
get t = tmin and prim = 1). Before the kernel it clamps tmin >= 0 and
tmax to the ray's exit from the scene AABB (`_scene_exit_t`), as the
reference does.

For CUDA tensors the wrapper launches ``csrc/binned.cu``, the cluster
walk of ``csrc/cluster_walk.cuh`` (a warp per ray, a cluster's 128
triangles across its lanes); for CPU tensors it runs `_intersect_plain`,
a loop over groups and clusters with a per-ray slab cull, vectorised over
the rays. Both test the same (ray, cluster) pairs in index order with the
same arithmetic (`_baldwin`) and keep torch.min's first minimum, so they
agree to the bit, ties included. `accel/cluster_walk.py` models the
kernel's own order (lanes, box chunks, the shuffle reduction) for the
tests.

Not ported, because they exist only for the TPU: the tile worklist
prepass (`_tile_worklists`, `_bitonic_rows`), `probe_ray_tile` and the
kernel's experiment knobs.

Animated geometry: `plan_binned_order` plans the cluster order once on
the host (a median split per instance, so a cluster never spans two
instances and stays tight under rigid motion), and
`build_binned_from_order` refreshes the rows and boxes from that order
for each frame's world-space triangles with plain torch ops on their
device (the JAX package does it in one jitted XLA op, not in Pallas).

``LAUNCHES`` counts the wrapper calls that launched the CUDA kernel;
``VISITS`` the (ray, cluster) pairs the plain version tested triangles
for, the work that chip_smoke.py's bound counts.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from henjou_torch.accel.pallas_cluster import K, _BIG, _safe_inv, _slab
from henjou_torch.accel.pallas_cluster_hbm import SC
from henjou_torch.csrc import INT, PTR, bind, check
from henjou_torch.math.constants import TMAX_RAY

# cluster groups per worklist entry: 1 up to this many clusters, SC above
MAX_FINE_CLUSTERS = 512
# group size doubles until the number of groups is at most this
MAX_GROUPS = 256

LAUNCHES = 0
VISITS = 0


@dataclasses.dataclass(frozen=True)
class BinnedClusters:
    rows: torch.Tensor  # [Ctot*16, K] f32: planes 0-11 geometry, 12 = tri ids
    aabb: torch.Tensor  # [8, Cp] per-cluster AABBs
    gaabb: torch.Tensor  # [8, Gp] per-group AABBs (== aabb when group=1)
    scene_lo: torch.Tensor  # [3] scene AABB (for exact tmax clamping)
    scene_hi: torch.Tensor  # [3]
    num_clusters: int
    group: int  # clusters per group
    num_groups: int
    k: int = K


def _median_split_order(centroids: np.ndarray, k: int = K) -> np.ndarray:
    """Top-down median-split ordering: recursively split along the widest
    centroid axis, keeping every left part a multiple of K so consecutive
    K-chunks of the output are the tree's leaves."""
    t = centroids.shape[0]
    out = np.empty(t, np.int64)
    pos = 0
    stack = [np.arange(t)]
    while stack:
        s = stack.pop()
        if len(s) <= k:
            out[pos : pos + len(s)] = s
            pos += len(s)
            continue
        c = centroids[s]
        ax = int((c.max(axis=0) - c.min(axis=0)).argmax())
        m = max(k, (len(s) // 2 // k) * k)
        part = np.argsort(c[:, ax], kind="stable")
        stack.append(s[part[m:]])
        stack.append(s[part[:m]])
    assert pos == t
    return out.astype(np.int32)


def _baldwin_rows_np(v0, e1, e2):
    """Per-triangle Baldwin-Weber transform (12 floats): plane (n, d)
    plus two affine barycentric rows (g1,h1), (g2,h2) with
    u = g1·P + h1, v = g2·P + h2 for P on the plane. Degenerate triangles
    get all-zero rows -> n·d == 0 -> culled like a zero determinant."""
    n = np.cross(e1, e2)
    nn = (n * n).sum(axis=1, keepdims=True)
    ok = nn > 0.0
    inv_nn = np.where(ok, 1.0 / np.where(ok, nn, 1.0), 0.0)
    g1 = np.cross(e2, n) * inv_nn
    g2 = np.cross(n, e1) * inv_nn
    n = np.where(ok, n, 0.0)
    d = (n * v0).sum(axis=1)
    h1 = -(g1 * v0).sum(axis=1)
    h2 = -(g2 * v0).sum(axis=1)
    return n, d, g1, h1, g2, h2


def pack_binned_np(tri_verts, device, k: int = K) -> BinnedClusters:
    """Host-side numpy build: median-split triangles into K-wide leaf
    clusters, fold the original-id plane into the rows (plane 12), union
    group AABBs, and upload the result to `device`."""
    tv = np.asarray(tri_verts, np.float32)
    t = tv.shape[0]
    centroids = tv.mean(axis=1)
    order = _median_split_order(centroids, k)

    pad = (-t) % k
    c = (t + pad) // k
    group, g = _cluster_groups(c)
    ctot = g * group

    order_p = np.full(ctot * k, -1, np.int32)
    order_p[:t] = order
    verts = np.zeros((ctot * k, 3, 3), np.float32)
    verts[:t] = tv[order]

    v0 = verts[:, 0]
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]

    valid = (order_p >= 0).reshape(ctot, k)
    vmin = np.where(valid[..., None, None], verts.reshape(ctot, k, 3, 3), _BIG)
    vmax = np.where(valid[..., None, None], verts.reshape(ctot, k, 3, 3), -_BIG)
    amin = vmin.reshape(ctot, k * 3, 3).min(axis=1)
    amax = vmax.reshape(ctot, k * 3, 3).max(axis=1)

    cp = max(8, int(np.ceil(ctot / 8) * 8))
    aabb = np.full((8, cp), _BIG, np.float32)
    aabb[0:3, :ctot] = amin.T
    aabb[3:6, :ctot] = amax.T
    aabb[3:6, ctot:] = -_BIG

    gmins = amin.reshape(g, group, 3).min(axis=1)
    gmaxs = amax.reshape(g, group, 3).max(axis=1)
    gp = max(8, int(np.ceil(g / 8) * 8))
    gaabb = np.full((8, gp), _BIG, np.float32)
    gaabb[0:3, :g] = gmins.T
    gaabb[3:6, :g] = gmaxs.T
    gaabb[3:6, g:] = -_BIG

    nrm, dpl, g1, h1, g2, h2 = _baldwin_rows_np(v0, e1, e2)
    rows = np.zeros((ctot, 16, k), np.float32)
    comps = [nrm[:, 0], nrm[:, 1], nrm[:, 2], dpl,
             g1[:, 0], g1[:, 1], g1[:, 2], h1,
             g2[:, 0], g2[:, 1], g2[:, 2], h2]
    for i, comp in enumerate(comps):
        rows[:, i, :] = comp.reshape(ctot, k)
    rows[:, 12, :] = order_p.reshape(ctot, k).view(np.float32)
    rows = rows.reshape(-1, k)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return BinnedClusters(
        rows=up(rows),
        aabb=up(aabb),
        gaabb=up(gaabb),
        scene_lo=up(amin.min(axis=0)),
        scene_hi=up(amax.max(axis=0)),
        num_clusters=c,
        group=group,
        num_groups=g,
        k=k,
    )


def _cluster_groups(c: int):
    """(group, num_groups) for c clusters: one cluster per group up to
    MAX_FINE_CLUSTERS, SC above, doubled until there are at most
    MAX_GROUPS groups."""
    group = 1 if c <= MAX_FINE_CLUSTERS else SC
    while group > 1 and group < 64 and (c + group - 1) // group > MAX_GROUPS:
        group *= 2
    return group, (c + group - 1) // group


def plan_binned_order(tri_verts, geom_ranges=None):
    """The cluster order of an animated scene, planned once on the host:
    each (start_tri, count) range of `geom_ranges` (one per instance;
    default the whole scene) is median-split on its own and padded to a
    multiple of K with -1. Returns (order [Ctot*K] i32, num_clusters,
    group, num_groups), bit-equal to the JAX package's plan."""
    tv = np.asarray(tri_verts, np.float32)
    if geom_ranges is None:
        geom_ranges = [(0, tv.shape[0])]
    chunks = []
    for start, count in geom_ranges:
        if count == 0:
            continue
        sub = _median_split_order(tv[start : start + count].mean(axis=1)) + start
        chunks.append(np.concatenate([sub, np.full((-count) % K, -1, np.int32)]))
    order = np.concatenate(chunks) if chunks else np.zeros(0, np.int32)
    c = len(order) // K
    group, g = _cluster_groups(c)
    order = np.concatenate([order, np.full(g * group * K - len(order), -1, np.int32)])
    return order.astype(np.int32), c, group, g


def _cross(a, b):
    """a x b as separate elementwise ops (numpy's order of operations; one
    kernel per op on CUDA, so nothing contracts into an FMA)."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def build_binned_from_order(tri_verts: torch.Tensor, order, num_clusters: int, group: int,
                            num_groups: int) -> BinnedClusters:
    """The pack of the current world-space triangles `tri_verts` [T,3,3] in
    the planned `order` (`plan_binned_order`), on the triangles' device:
    one gather, dense min/max reductions for the boxes (pads hold _BIG),
    the Baldwin-Weber rows in `_baldwin_rows_np`'s order of operations,
    and the order bit-cast into row 12."""
    dev = tri_verts.device
    order = torch.as_tensor(order, dtype=torch.int32, device=dev)
    ctot = num_groups * group
    valid = (order >= 0)[:, None, None]
    verts = torch.where(valid, tri_verts[order.clamp(min=0).long()], 0.0)  # [Ctot*K,3,3]
    v0 = verts[:, 0]
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]

    amin = torch.where(valid, verts, _BIG).reshape(ctot, K * 3, 3).amin(dim=1)
    amax = torch.where(valid, verts, -_BIG).reshape(ctot, K * 3, 3).amax(dim=1)

    def boxes(lo, hi, n):
        cols = max(8, -(-n // 8) * 8)
        box = torch.full((8, cols), _BIG, dtype=torch.float32, device=dev)
        box[3:6] = -_BIG
        box[0:3, :n] = lo.T
        box[3:6, :n] = hi.T
        return box

    gmin = amin.reshape(num_groups, group, 3).amin(dim=1)
    gmax = amax.reshape(num_groups, group, 3).amax(dim=1)

    nrm = _cross(e1, e2)
    nn = _dot(nrm, nrm)[:, None]
    ok = nn > 0.0
    inv_nn = torch.where(ok, 1.0 / torch.where(ok, nn, 1.0), 0.0)
    g1 = _cross(e2, nrm) * inv_nn
    g2 = _cross(nrm, e1) * inv_nn
    nrm = torch.where(ok, nrm, 0.0)
    zero = torch.zeros_like(nn[:, 0])
    planes = [nrm[:, 0], nrm[:, 1], nrm[:, 2], _dot(nrm, v0),
              g1[:, 0], g1[:, 1], g1[:, 2], -_dot(g1, v0),
              g2[:, 0], g2[:, 1], g2[:, 2], -_dot(g2, v0),
              order.view(torch.float32), zero, zero, zero]
    rows = torch.stack(planes, dim=1).reshape(ctot, K, 16).transpose(1, 2).reshape(-1, K)
    return BinnedClusters(
        rows=rows.contiguous(),
        aabb=boxes(amin, amax, ctot),
        gaabb=boxes(gmin, gmax, num_groups),
        scene_lo=amin.amin(dim=0),  # pad clusters hold +_BIG: no effect
        scene_hi=amax.amax(dim=0),
        num_clusters=num_clusters,
        group=group,
        num_groups=num_groups,
        k=K,
    )


def _scene_exit_t(bc: BinnedClusters, ray_o, ray_d, tmin):
    """Per-ray exit t of the scene AABB (slab), with a relative safety
    margin; rays missing the box get tmin (zero-width = dead)."""
    iv = _safe_inv(ray_d)
    t1 = (bc.scene_lo[None, :] - ray_o) * iv
    t2 = (bc.scene_hi[None, :] - ray_o) * iv
    t_exit = torch.amin(torch.maximum(t1, t2), dim=1)
    t_enter = torch.amax(torch.minimum(t1, t2), dim=1)
    t_exit = t_exit * (1.0 + 1e-4) + 1e-5
    return torch.where((t_exit >= t_enter) & (t_exit > tmin), t_exit, tmin)


def _baldwin(cl, o, d, tmin, best_t):
    """Baldwin-Weber of rays o, d [n,3] against one cluster's rows cl
    [16, K], in the kernel's operation order (csrc/cluster_walk.cuh
    `BinnedTest`). Returns (t, u, v, ok), each [n, K]."""
    o = o[:, :, None]  # [n,3,1]
    d = d[:, :, None]
    nd = d[:, 0] * cl[0] + d[:, 1] * cl[1] + d[:, 2] * cl[2]
    no = o[:, 0] * cl[0] + o[:, 1] * cl[1] + o[:, 2] * cl[2]
    inv_nd = torch.where(nd.abs() > 1e-12, 1.0 / nd, 0.0)
    tt = (cl[3] - no) * inv_nd
    px = o[:, 0] + tt * d[:, 0]
    py = o[:, 1] + tt * d[:, 1]
    pz = o[:, 2] + tt * d[:, 2]
    uu = cl[7] + cl[4] * px + cl[5] * py + cl[6] * pz
    vv = cl[11] + cl[8] * px + cl[9] * py + cl[10] * pz
    ok = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (tt > tmin[:, None]) & (tt < best_t[:, None]))
    return tt, uu, vv, ok


def _intersect_plain(bc: BinnedClusters, ray_o, ray_d, tmin, tmax, any_hit):
    """Plain PyTorch version of the kernel on clamped (tmin, tmax): groups,
    then clusters, in index order; per-ray slab culls against
    [tmin, best_t]; dense Baldwin-Weber tests of the kept rays against the
    cluster's K triangles. Returns (t, prim, u, v) before the miss fill."""
    global VISITS
    r = ray_o.shape[0]
    kk = bc.k
    inv = _safe_inv(ray_d)
    best_t = tmax.clone()
    best_p = torch.full((r,), -1, dtype=torch.int32, device=ray_o.device)
    best_u = torch.zeros(r, dtype=torch.float32, device=ray_o.device)
    best_v = torch.zeros(r, dtype=torch.float32, device=ray_o.device)
    rows = bc.rows.view(-1, 16, kk)
    all_rays = torch.arange(r, device=ray_o.device)
    for g in range(bc.num_groups):
        keep = _slab(bc.gaabb, g, ray_o, inv, tmin, best_t)
        if any_hit:
            keep &= best_p < 0
        idx_g = all_rays[keep]
        if idx_g.numel() == 0:
            continue
        for j in range(bc.group):
            c = g * bc.group + j
            if c >= bc.num_clusters:
                break
            keep_c = _slab(bc.aabb, c, ray_o[idx_g], inv[idx_g],
                           tmin[idx_g], best_t[idx_g])
            idx = idx_g[keep_c]
            if idx.numel() == 0:
                continue
            VISITS += idx.numel()
            cl = rows[c]  # [16, K]
            tt, uu, vv, ok = _baldwin(cl, ray_o[idx], ray_d[idx], tmin[idx], best_t[idx])
            hit_any = ok.any(dim=1)
            if any_hit:
                hit_idx = idx[hit_any]
                best_t[hit_idx] = tmin[hit_idx]
                best_p[hit_idx] = 1
                continue
            tt_m = torch.where(ok, tt, torch.inf)
            t_k, k_best = torch.min(tt_m, dim=1)  # first minimum: lowest k
            u_k = uu.gather(1, k_best[:, None])[:, 0]
            v_k = vv.gather(1, k_best[:, None])[:, 0]
            prim_k = cl[12].view(torch.int32)[k_best]
            hit_idx = idx[hit_any]
            best_t[hit_idx] = t_k[hit_any]
            best_p[hit_idx] = prim_k[hit_any]
            best_u[hit_idx] = u_k[hit_any]
            best_v[hit_idx] = v_k[hit_any]
    return best_t, best_p, best_u, best_v


@functools.cache
def _kernel_fn():
    return bind(
        "henjou_binned_intersect",
        [PTR, PTR, INT, PTR, INT, INT, INT, INT,
         PTR, PTR, PTR, PTR, INT, INT,
         PTR, PTR, PTR, PTR, PTR],
    )


def _intersect_cuda(bc: BinnedClusters, ray_o, ray_d, tmin, tmax, any_hit):
    global LAUNCHES
    for name, x in (("rows", bc.rows), ("aabb", bc.aabb), ("gaabb", bc.gaabb)):
        if x.device != ray_o.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"bc.{name} must be contiguous f32 on {ray_o.device}")
    if bc.rows.shape != (bc.num_groups * bc.group * 16, K) or bc.k != K:
        raise ValueError(f"bc.rows must be [Ctot*16, {K}], got {tuple(bc.rows.shape)}")
    if bc.rows.data_ptr() % 16:
        raise ValueError("bc.rows must be 16-byte aligned (the kernel loads float4)")
    r = ray_o.shape[0]
    ray_o = ray_o.contiguous()
    ray_d = ray_d.contiguous()
    tmin = tmin.contiguous()
    tmax = tmax.contiguous()
    t = torch.empty(r, dtype=torch.float32, device=ray_o.device)
    prim = torch.empty(r, dtype=torch.int32, device=ray_o.device)
    u = torch.empty(r, dtype=torch.float32, device=ray_o.device)
    v = torch.empty(r, dtype=torch.float32, device=ray_o.device)
    stream = torch.cuda.current_stream(ray_o.device).cuda_stream
    err = _kernel_fn()(
        bc.rows.data_ptr(), bc.aabb.data_ptr(), bc.aabb.shape[1],
        bc.gaabb.data_ptr(), bc.gaabb.shape[1],
        bc.num_clusters, bc.group, bc.num_groups,
        ray_o.data_ptr(), ray_d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
        r, int(any_hit),
        t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(), stream,
    )
    check(err, "henjou_binned_intersect")
    LAUNCHES += 1
    return t, prim, u, v


def _prepare(bc, ray_o, ray_d, tmin, tmax):
    if ray_o.dim() != 2 or ray_o.shape[1] != 3 or ray_d.shape != ray_o.shape:
        raise ValueError("ray_o and ray_d must both be [R, 3]")
    if ray_o.dtype != torch.float32 or ray_d.dtype != torch.float32:
        raise TypeError("rays must be float32")
    if bc.rows.device != ray_o.device:
        raise ValueError(f"clusters on {bc.rows.device}, rays on {ray_o.device}")
    r = ray_o.shape[0]
    dev = ray_o.device
    # tmin >= 0 is what lets the kernel drop explicit padding terms
    # (all-zero rows give tt == 0, culled by tt > tmin)
    tmin = torch.clamp(
        torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(r), min=0.0
    )
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(r)
    # exact tmax clamp: no hit lies beyond the ray's scene-AABB exit point
    tmax = torch.minimum(tmax, _scene_exit_t(bc, ray_o, ray_d, tmin))
    return tmin.contiguous(), tmax.contiguous()


def _finish(t, prim, u, v):
    hit = prim >= 0
    return torch.where(hit, t, torch.inf), prim, u, v, hit


def intersect_binned_plain(bc: BinnedClusters, ray_o, ray_d, tmin,
                           tmax=TMAX_RAY, any_hit: bool = False):
    """The plain PyTorch version on any device (see `intersect_binned`)."""
    tmin, tmax = _prepare(bc, ray_o, ray_d, tmin, tmax)
    return _finish(*_intersect_plain(bc, ray_o, ray_d, tmin, tmax, any_hit))


def intersect_binned(bc: BinnedClusters, ray_o, ray_d, tmin, tmax=TMAX_RAY,
                     any_hit: bool = False):
    """Same contract as accel.bruteforce.intersect_bruteforce: returns
    (t[R] or inf, prim[R] i32 or -1, u[R], v[R], hit[R]). Ray directions
    must be unit length (the scene-exit clamp measures t in Euclidean
    distance). Launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors."""
    if ray_o.device.type == "cpu":
        return intersect_binned_plain(bc, ray_o, ray_d, tmin, tmax, any_hit)
    if ray_o.device.type != "cuda":
        raise ValueError(f"unsupported device {ray_o.device}")
    tmin, tmax = _prepare(bc, ray_o, ray_d, tmin, tmax)
    return _finish(*_intersect_cuda(bc, ray_o, ray_d, tmin, tmax, any_hit))


def make_binned_intersector(bc: BinnedClusters, intersect=intersect_binned):
    """(intersect_fn, occluded_fn) over `bc` with the integrators'
    signatures; `intersect` may be `intersect_binned_plain`."""

    def intersect_fn(tri_verts, ray_o, ray_d, tmin, tmax=TMAX_RAY):
        return intersect(bc, ray_o, ray_d, tmin, tmax)

    def occluded_fn(tri_verts, ray_o, ray_d, tmin, tmax):
        return intersect(bc, ray_o, ray_d, tmin, tmax, any_hit=True)[4]

    return intersect_fn, occluded_fn
