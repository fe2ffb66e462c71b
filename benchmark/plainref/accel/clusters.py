"""The benchmark's own plain intersector: clusters of triangles in Morton
order, two levels of boxes, and dense Baldwin-Weber tests of the
(ray, cluster) pairs whose boxes the ray crosses.

It shares no code with the program. The per-triangle Baldwin-Weber rows are
worked out here from the frame's world-space triangles with the same
arithmetic as the published test (plane (n, d) and two affine barycentric
rows), and the test's operation order follows it, so a hit's t, u and v are
what any exact implementation of that test gives. The closest hit is the
smallest t, ties to the lowest triangle id.

`dtype=torch.bfloat16` computes the tests in bfloat16: the benchmark's
control, a lower-precision trace that the comparison has to reject.
"""

from __future__ import annotations

import numpy as np
import torch

CLUSTER = 32  # triangles per cluster
GROUP = 16  # clusters per group
_I64_MAX = torch.iinfo(torch.int64).max


def baldwin_rows_np(tri_verts: np.ndarray) -> np.ndarray:
    """[T, 12] f32 rows (n, d, g1, h1, g2, h2) of [T, 3, 3] triangles.
    Degenerate triangles get all-zero rows, which no ray hits."""
    tv = np.asarray(tri_verts, np.float32)
    v0 = tv[:, 0]
    e1 = tv[:, 1] - v0
    e2 = tv[:, 2] - v0
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
    return np.concatenate([n, d[:, None], g1, h1[:, None], g2, h2[:, None]],
                          axis=1).astype(np.float32)


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    lo = centroids.min(axis=0)
    ext = np.maximum(centroids.max(axis=0) - lo, 1e-30)
    q = np.clip(((centroids - lo) / ext * 1023.0).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return np.argsort(code, kind="stable")


class PlainClusters:
    """Triangles of one frame grouped for `intersect` and `occluded`."""

    def __init__(self, tri_verts: torch.Tensor):
        dev = tri_verts.device
        tv = tri_verts.detach().cpu().numpy().astype(np.float32)
        t = tv.shape[0]
        order = _morton_order(tv.mean(axis=1))
        c = -(-t // CLUSTER)
        g = -(-c // GROUP)
        c = g * GROUP
        ids = np.full(c * CLUSTER, -1, np.int64)
        ids[:t] = order
        rows = baldwin_rows_np(tv)
        rows_c = np.zeros((c * CLUSTER, 12), np.float32)
        rows_c[:t] = rows[order]
        valid = ids >= 0
        verts = tv[np.maximum(ids, 0)].reshape(c, CLUSTER, 3, 3)
        real = valid.reshape(c, CLUSTER, 1, 1)
        vmin = np.where(real, verts, np.inf).reshape(c, CLUSTER * 3, 3).min(axis=1)
        vmax = np.where(real, verts, -np.inf).reshape(c, CLUSTER * 3, 3).max(axis=1)
        # clusters of padding only: a far point no ray reaches
        empty = ~valid.reshape(c, CLUSTER).any(axis=1)
        vmin[empty] = 3e37
        vmax[empty] = 3e37
        # boxes padded by a margin relative to the scene's size, so rounding
        # in the slab test never culls a hit
        scene = float(np.abs(tv).max()) if t else 1.0
        pad = 1e-5 * scene
        vmin = vmin - pad
        vmax = vmax + pad
        gmin = vmin.reshape(g, GROUP, 3).min(axis=1)
        gmax = vmax.reshape(g, GROUP, 3).max(axis=1)

        def up(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

        self.ids = up(ids.reshape(c, CLUSTER), torch.int64)
        self.rows = up(rows_c.reshape(c, CLUSTER, 12).transpose(0, 2, 1))  # [C,12,K]
        self.lo, self.hi = up(vmin), up(vmax)
        self.glo, self.ghi = up(gmin), up(gmax)
        self.num_clusters = c
        self.num_groups = g


def _safe_inv(d):
    tiny = 1e-30
    return 1.0 / torch.where(d.abs() < tiny, torch.where(d < 0, -tiny, tiny), d)


def _slab(lo, hi, o, inv, tmin, tmax):
    """[n, m] mask of the rays o, inv ([n,3]) crossing boxes lo, hi ([n,m,3]
    or [m,3]) inside [tmin, tmax] ([n])."""
    t1 = (lo - o[:, None, :]) * inv[:, None, :]
    t2 = (hi - o[:, None, :]) * inv[:, None, :]
    tn = torch.minimum(t1, t2).amax(dim=-1)
    tf = torch.maximum(t1, t2).amin(dim=-1)
    return (tf >= tn) & (tf >= tmin[:, None]) & (tn <= tmax[:, None])


def _baldwin(cl, o, d, tmin, tmax):
    """The Baldwin-Weber test of rays o, d [n,3] against rows cl [n,12,K]:
    (t, u, v, ok) [n,K]."""
    o = o[:, :, None]
    d = d[:, :, None]
    nd = d[:, 0] * cl[:, 0] + d[:, 1] * cl[:, 1] + d[:, 2] * cl[:, 2]
    no = o[:, 0] * cl[:, 0] + o[:, 1] * cl[:, 1] + o[:, 2] * cl[:, 2]
    inv_nd = torch.where(nd.abs() > 1e-12, 1.0 / nd, 0.0)
    tt = (cl[:, 3] - no) * inv_nd
    px = o[:, 0] + tt * d[:, 0]
    py = o[:, 1] + tt * d[:, 1]
    pz = o[:, 2] + tt * d[:, 2]
    uu = cl[:, 7] + cl[:, 4] * px + cl[:, 5] * py + cl[:, 6] * pz
    vv = cl[:, 11] + cl[:, 8] * px + cl[:, 9] * py + cl[:, 10] * pz
    ok = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
          & (tt > tmin[:, None]) & (tt < tmax[:, None]))
    return tt, uu, vv, ok


def _pairs(pc: PlainClusters, o, inv, tmin, tmax):
    """(ray, cluster) pairs whose boxes the rays cross, group level first."""
    ray_g, grp = torch.nonzero(_slab(pc.glo, pc.ghi, o, inv, tmin, tmax), as_tuple=True)
    if ray_g.numel() == 0:
        return ray_g, grp
    cl = grp[:, None] * GROUP + torch.arange(GROUP, device=o.device)[None, :]
    keep = _slab(pc.lo[cl], pc.hi[cl], o[ray_g], inv[ray_g], tmin[ray_g], tmax[ray_g])
    sel, j = torch.nonzero(keep, as_tuple=True)
    return ray_g[sel], cl[sel, j]


def intersect(pc: PlainClusters, ray_o, ray_d, tmin, tmax, any_hit: bool = False,
              dtype=torch.float32, ray_chunk: int = 8192, pair_chunk: int = 1 << 17):
    """Closest hit (t or inf, prim or -1, u, v, hit) of [R,3] rays inside
    (tmin, tmax), or with ``any_hit`` a hit flag per ray."""
    r = ray_o.shape[0]
    dev = ray_o.device
    tmin = torch.clamp(torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(r),
                       min=0.0).contiguous()
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(r).contiguous()
    key = torch.full((r,), _I64_MAX, dtype=torch.int64, device=dev)
    u_out = torch.zeros(r, dtype=torch.float32, device=dev)
    v_out = torch.zeros(r, dtype=torch.float32, device=dev)
    blocked = torch.zeros(r, dtype=torch.bool, device=dev)
    inv = _safe_inv(ray_d)
    for base in range(0, r, ray_chunk):
        sl = slice(base, min(base + ray_chunk, r))
        live = tmax[sl] > tmin[sl]
        rays, cls = _pairs(pc, ray_o[sl], inv[sl], tmin[sl], torch.where(live, tmax[sl], -1.0))
        rays = rays + base
        for pb in range(0, rays.numel(), pair_chunk):
            ri = rays[pb:pb + pair_chunk]
            ci = cls[pb:pb + pair_chunk]
            tt, uu, vv, ok = _baldwin(pc.rows[ci].to(dtype), ray_o[ri].to(dtype),
                                      ray_d[ri].to(dtype), tmin[ri].to(dtype),
                                      tmax[ri].to(dtype))
            ok = ok & (pc.ids[ci] >= 0)
            if any_hit:
                blocked[ri[ok.any(dim=1)]] = True
                continue
            tt = tt.float()
            tbits = tt.contiguous().view(torch.int32).to(torch.int64)
            k = torch.where(ok, (tbits << 32) | pc.ids[ci], _I64_MAX)
            kmin, kj = k.min(dim=1)
            key.scatter_reduce_(0, ri, kmin, reduce="amin")
            win = (kmin == key[ri]) & (kmin != _I64_MAX)
            u_out[ri[win]] = uu.float().gather(1, kj[:, None])[:, 0][win]
            v_out[ri[win]] = vv.float().gather(1, kj[:, None])[:, 0][win]
    if any_hit:
        return blocked
    hit = key != _I64_MAX
    t = torch.where(hit, (key >> 32).to(torch.int32).view(torch.float32), torch.inf)
    prim = torch.where(hit, key & 0xFFFFFFFF, -1).to(torch.int32)
    return t, prim, torch.where(hit, u_out, 0.0), torch.where(hit, v_out, 0.0), hit


def make_intersector(pc: PlainClusters, dtype=torch.float32):
    """(intersect_fn, occluded_fn) in the engine's calling form."""

    def intersect_fn(tri_verts, ray_o, ray_d, tmin, tmax):
        return intersect(pc, ray_o, ray_d, tmin, tmax, dtype=dtype)

    def occluded_fn(tri_verts, ray_o, ray_d, tmin, tmax):
        return intersect(pc, ray_o, ray_d, tmin, tmax, any_hit=True, dtype=dtype)

    return intersect_fn, occluded_fn
