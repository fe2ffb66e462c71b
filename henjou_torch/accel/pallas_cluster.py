"""Flat cluster-scan intersector: tensor pack, CUDA kernel, plain version.

Port of henjou_tpu/accel/pallas_cluster.py, the first-generation packet/
cluster intersector that the JAX renderer no longer routes (tools and
tests reach it). `pack_clusters` Morton-orders the triangles (stable
argsort, as `jnp.argsort`) and cuts them into clusters of K = 128, as nine
component planes v0 | e1 | e2 of [C, K], the original ids `order` and the
cluster AABBs [8, Cp]; every field equals the JAX pack's.

`intersect_pallas` keeps the reference's contract,

    (t or inf, prim or -1, u, v, hit),

with no clamp of tmin or tmax: a ray with tmax 0 (the TPU wrapper's
padding lane) misses at once. For CUDA tensors it launches
``csrc/cluster.cu`` (the warp-per-ray cluster walk of
``csrc/cluster_walk.cuh``, the cluster boxes as its one box level); for
CPU tensors it runs `_intersect_plain`, which walks the clusters in index
order with a per-ray slab cull and the same Moller-Trumbore arithmetic,
vectorised over the rays. The two visit the same (ray, cluster) pairs in
the same order and agree to the bit (`accel/cluster_walk.py` models the
kernel's order on the CPU). Both cull per ray where the TPU kernel culled
per 512-ray tile; a ray never hits inside a box its slab test rejects, so
that changes no hit beyond ties at a box's edge. With ``any_hit=True`` a
ray stops at its first accepted triangle and returns that hit (only `hit`
is meant to be read).

The helpers below (`_safe_inv`, `_slab`, `_prepare`, `_mt`, `_take`,
`_launch`, `_finish`) also serve the two-level and matrix-form
intersectors (`pallas_cluster_hbm.py`, `pallas_mxu.py`); the binned
intersector takes `K`, `_BIG`, `_safe_inv` and `_slab` from here, as the
JAX package's takes its constants.

``LAUNCHES`` counts the wrapper calls that launched the CUDA kernel;
``VISITS`` the (ray, cluster) pairs the plain version tested triangles
for, the work that chip_smoke.py's bound counts.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from henjou_torch.accel.lbvh import morton_codes
from henjou_torch.csrc import INT, PTR, bind, check
from henjou_torch.math.constants import TMAX_RAY

K = 128  # triangles per cluster (the TPU's lane width)
# rays per TPU grid step; the TPU wrapper padded the batch to a multiple
# of it with dead lanes. The CUDA kernel takes any count.
RAY_TILE = 512
_BIG = 3.0e38

LAUNCHES = 0
VISITS = 0


@dataclasses.dataclass(frozen=True)
class PackedClusters:
    """SoA planes [C, K]; AABB [8, Cp] (rows 0-2 min xyz, 3-5 max xyz)."""

    v0x: torch.Tensor
    v0y: torch.Tensor
    v0z: torch.Tensor
    e1x: torch.Tensor
    e1y: torch.Tensor
    e1z: torch.Tensor
    e2x: torch.Tensor
    e2y: torch.Tensor
    e2z: torch.Tensor
    order: torch.Tensor  # [C, K] i32, -1 padding
    aabb: torch.Tensor  # [8, Cp]
    num_clusters: int

    def planes(self):
        return (self.v0x, self.v0y, self.v0z, self.e1x, self.e1y, self.e1z,
                self.e2x, self.e2y, self.e2z)


def pack_clusters(tri_verts: torch.Tensor) -> PackedClusters:
    """Morton-sort and pack [T,3,3] f32 triangles into K-wide clusters, on
    the device of `tri_verts`."""
    t = tri_verts.shape[0]
    dev = tri_verts.device
    centroids = torch.mean(tri_verts, dim=1)
    flat = tri_verts.reshape(-1, 3)
    codes = morton_codes(centroids, flat.amin(dim=0), flat.amax(dim=0))
    order = torch.argsort(codes, stable=True).to(torch.int32)

    pad = (-t) % K
    c = (t + pad) // K
    order_p = torch.cat([order, torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    verts = torch.cat([tri_verts[order.long()],
                       torch.zeros((pad, 3, 3), dtype=tri_verts.dtype, device=dev)])
    v0 = verts[:, 0]
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]

    valid = (order_p >= 0).reshape(c, K)
    vmin = torch.where(valid[..., None, None], verts.reshape(c, K, 3, 3), _BIG)
    vmax = torch.where(valid[..., None, None], verts.reshape(c, K, 3, 3), -_BIG)
    amin = vmin.reshape(c, K * 3, 3).amin(dim=1)
    amax = vmax.reshape(c, K * 3, 3).amax(dim=1)

    cp = max(8, -(-c // 8) * 8)
    aabb = torch.full((8, cp), _BIG, dtype=torch.float32, device=dev)
    aabb[0:3, :c] = amin.T
    aabb[3:6, :c] = amax.T
    aabb[3:6, c:] = -_BIG  # padded clusters never hit

    def plane(x):
        return x.reshape(c, K).contiguous()

    return PackedClusters(
        v0x=plane(v0[:, 0]), v0y=plane(v0[:, 1]), v0z=plane(v0[:, 2]),
        e1x=plane(e1[:, 0]), e1y=plane(e1[:, 1]), e1z=plane(e1[:, 2]),
        e2x=plane(e2[:, 0]), e2y=plane(e2[:, 1]), e2z=plane(e2[:, 2]),
        order=plane(order_p),
        aabb=aabb,
        num_clusters=c,
    )


# ---------------- helpers shared with pallas_cluster_hbm, pallas_mxu and pallas_binned ----------------


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1 / d with |d| < 1e-12 replaced by +-1e-12 (the kernels' `inv`)."""
    tiny = torch.where(d >= 0.0, 1e-12, -1e-12).to(d.dtype)
    return 1.0 / torch.where(d.abs() < 1e-12, tiny, d)


def _slab(box, col, o, inv, t_lo, t_hi):
    """Per-ray slab test of AABB column `col` of an [8, *] table against
    [t_lo, t_hi]: common.cuh's `slab`, vectorised over rays."""
    te, tx = t_lo, t_hi
    for a in range(3):
        t1 = (box[a, col] - o[:, a]) * inv[:, a]
        t2 = (box[3 + a, col] - o[:, a]) * inv[:, a]
        te = torch.maximum(te, torch.minimum(t1, t2))
        tx = torch.minimum(tx, torch.maximum(t1, t2))
    return te <= tx


def _prepare(ray_o, ray_d, tmin, tmax, ref: torch.Tensor):
    """Check the rays against the pack tensor `ref` and broadcast tmin and
    tmax to contiguous f32 [R]."""
    if ray_o.dim() != 2 or ray_o.shape[1] != 3 or ray_d.shape != ray_o.shape:
        raise ValueError("ray_o and ray_d must both be [R, 3]")
    if ray_o.dtype != torch.float32 or ray_d.dtype != torch.float32:
        raise TypeError("rays must be float32")
    if ref.device != ray_o.device:
        raise ValueError(f"clusters on {ref.device}, rays on {ray_o.device}")
    r = ray_o.shape[0]
    dev = ray_o.device
    tmin = torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(r)
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(r)
    return tmin.contiguous(), tmax.contiguous()


def _mt(o, d, v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, tmin, best_t):
    """Moller-Trumbore of rays o, d [n,3] against K triangles given as [K]
    component rows, in the TPU kernel's operation order (the kernels'
    common.cuh `mt`). Returns (t, u, v, ok), each [n, K]; `ok` does not
    yet include the padding test (order >= 0)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = det.abs() > 1e-12
    inv_det = torch.where(det_ok, 1.0 / det, 0.0)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    ok = _accept(det_ok, uu, vv, tt, tmin, best_t)
    return tt, uu, vv, ok


def _accept(det_ok, uu, vv, tt, tmin, best_t):
    """The kernels' accept test on [n, K] candidates for rays with [n]
    tmin and best t."""
    return (det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
            & (tt > tmin[:, None]) & (tt < best_t[:, None]))


def _new_best(tmax):
    r = tmax.shape[0]
    dev = tmax.device
    return (tmax.clone(), torch.full((r,), -1, dtype=torch.int32, device=dev),
            torch.zeros(r, dtype=torch.float32, device=dev),
            torch.zeros(r, dtype=torch.float32, device=dev))


def _take(best, idx, ok, tt, uu, vv, order_row, any_hit: bool):
    """Fold one cluster's [n, K] results for the rays `idx` into `best` =
    (t, prim, u, v), in place. A closest hit takes the lowest k among the
    smallest t (torch.min returns the first minimum), as the kernels'
    strict `<` in ascending k does; an any hit takes the first accepted
    k, where the kernels stop."""
    best_t, best_p, best_u, best_v = best
    ok = ok & (order_row >= 0)
    hit_any = ok.any(dim=1)
    if any_hit:
        k_sel = torch.argmax(ok.to(torch.int32), dim=1)  # the first True
        t_sel = tt.gather(1, k_sel[:, None])[:, 0]
    else:
        t_sel, k_sel = torch.min(torch.where(ok, tt, torch.inf), dim=1)
    hit_idx = idx[hit_any]
    best_t[hit_idx] = t_sel[hit_any]
    best_p[hit_idx] = order_row[k_sel][hit_any]
    best_u[hit_idx] = uu.gather(1, k_sel[:, None])[:, 0][hit_any]
    best_v[hit_idx] = vv.gather(1, k_sel[:, None])[:, 0][hit_any]


def _kept(box, col, ray_o, inv, tmin, best, any_hit, idx=None):
    """The rays of `idx` (all when None) whose slab test against box `col`
    of `box` passes over [tmin, best t]; with any_hit, only rays without
    a hit yet."""
    if idx is None:
        keep = _slab(box, col, ray_o, inv, tmin, best[0])
        if any_hit:
            keep &= best[1] < 0
        return torch.arange(ray_o.shape[0], device=ray_o.device)[keep]
    return idx[_slab(box, col, ray_o[idx], inv[idx], tmin[idx], best[0][idx])]


def _finish(t, prim, u, v):
    hit = prim >= 0
    return torch.where(hit, t, torch.inf), prim, u, v, hit


def _check_pack(ray_o, **tensors):
    for name, (x, dtype) in tensors.items():
        if x.device != ray_o.device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on {ray_o.device}")


def _launch(fn, what: str, pack_args, ray_o, ray_d, tmin, tmax, any_hit):
    """Launch a C entry point with the layout (pack args..., ray_o, ray_d,
    tmin, tmax, n, any_hit, t, prim, u, v, stream) on the current stream;
    returns (t, prim, u, v) before the miss fill."""
    r = ray_o.shape[0]
    dev = ray_o.device
    ray_o = ray_o.contiguous()
    ray_d = ray_d.contiguous()
    t = torch.empty(r, dtype=torch.float32, device=dev)
    prim = torch.empty(r, dtype=torch.int32, device=dev)
    u = torch.empty(r, dtype=torch.float32, device=dev)
    v = torch.empty(r, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*pack_args, ray_o.data_ptr(), ray_d.data_ptr(), tmin.data_ptr(),
             tmax.data_ptr(), r, int(any_hit), t.data_ptr(), prim.data_ptr(),
             u.data_ptr(), v.data_ptr(), stream)
    check(err, what)
    return t, prim, u, v


# the C entry points end in the rays, outputs and stream of `_launch`
RAY_ARGS = [PTR, PTR, PTR, PTR, INT, INT, PTR, PTR, PTR, PTR, PTR]


def _dispatch(plain, cuda, pack_ref, ray_o, ray_d, tmin, tmax):
    """The wrappers' device rule: the plain version for CPU tensors, the
    kernel for CUDA tensors, an error for anything else."""
    tmin, tmax = _prepare(ray_o, ray_d, tmin, tmax, pack_ref)
    if ray_o.device.type == "cpu":
        return _finish(*plain(ray_o, ray_d, tmin, tmax))
    if ray_o.device.type != "cuda":
        raise ValueError(f"unsupported device {ray_o.device}")
    return _finish(*cuda(ray_o, ray_d, tmin, tmax))


# ---------------- the flat scan ----------------


def _intersect_plain(pc: PackedClusters, ray_o, ray_d, tmin, tmax, any_hit):
    """Plain PyTorch version of cluster.cu: every cluster in index order,
    a per-ray slab cull against [tmin, best_t], Moller-Trumbore of the
    kept rays against the cluster's K triangles."""
    global VISITS
    inv = _safe_inv(ray_d)
    best = _new_best(tmax)
    planes = pc.planes()
    for c in range(pc.num_clusters):
        idx = _kept(pc.aabb, c, ray_o, inv, tmin, best, any_hit)
        if idx.numel() == 0:
            continue
        VISITS += idx.numel()
        tt, uu, vv, ok = _mt(ray_o[idx], ray_d[idx], *(p[c] for p in planes),
                             tmin[idx], best[0][idx])
        _take(best, idx, ok, tt, uu, vv, pc.order[c], any_hit)
    return best


@functools.cache
def _kernel_fn():
    return bind("henjou_cluster_intersect", [PTR] * 11 + [INT, INT] + RAY_ARGS)


def _intersect_cuda(pc: PackedClusters, ray_o, ray_d, tmin, tmax, any_hit):
    global LAUNCHES
    f32 = torch.float32
    _check_pack(ray_o, order=(pc.order, torch.int32), aabb=(pc.aabb, f32),
                **{f"plane{i}": (p, f32) for i, p in enumerate(pc.planes())})
    if pc.order.shape != (pc.num_clusters, K):
        raise ValueError(f"pc.order must be [C, {K}], got {tuple(pc.order.shape)}")
    if any(x.data_ptr() % 16 for x in (*pc.planes(), pc.order)):
        raise ValueError("the planes and pc.order must be 16-byte aligned (the kernel loads "
                         "float4 and int4)")
    args = [p.data_ptr() for p in pc.planes()]
    args += [pc.order.data_ptr(), pc.aabb.data_ptr(), pc.aabb.shape[1], pc.num_clusters]
    out = _launch(_kernel_fn(), "henjou_cluster_intersect", args,
                  ray_o, ray_d, tmin, tmax, any_hit)
    LAUNCHES += 1
    return out


def intersect_pallas_plain(pc: PackedClusters, ray_o, ray_d, tmin, tmax=TMAX_RAY,
                           any_hit: bool = False):
    """The plain PyTorch version on any device (see `intersect_pallas`)."""
    tmin, tmax = _prepare(ray_o, ray_d, tmin, tmax, pc.aabb)
    return _finish(*_intersect_plain(pc, ray_o, ray_d, tmin, tmax, any_hit))


def intersect_pallas(pc: PackedClusters, ray_o, ray_d, tmin, tmax=TMAX_RAY,
                     any_hit: bool = False):
    """Same contract as accel.bruteforce.intersect_bruteforce. Launches
    ``csrc/cluster.cu`` for CUDA tensors and runs the plain version for
    CPU tensors."""
    return _dispatch(
        lambda *a: _intersect_plain(pc, *a, any_hit),
        lambda *a: _intersect_cuda(pc, *a, any_hit),
        pc.aabb, ray_o, ray_d, tmin, tmax,
    )


def make_pallas_intersector(pc, intersect=intersect_pallas):
    """(intersect_fn, occluded_fn) over the pack `pc` with the integrators'
    signatures. `intersect` is the pack's wrapper or its plain version;
    the two-level and matrix-form intersectors use this with theirs."""

    def intersect_fn(tri_verts, ray_o, ray_d, tmin, tmax=TMAX_RAY):
        return intersect(pc, ray_o, ray_d, tmin, tmax)

    def occluded_fn(tri_verts, ray_o, ray_d, tmin, tmax):
        return intersect(pc, ray_o, ray_d, tmin, tmax, any_hit=True)[4]

    return intersect_fn, occluded_fn
