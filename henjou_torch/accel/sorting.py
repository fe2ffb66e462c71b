"""Bounce-ray sorting around every trace (port of
henjou_tpu/accel/sorting.py: `ray_sort_key`, `DEAD_KEY`,
`make_sorted_intersector` and `make_bitonic_sorted_intersector`).

Before the kernel, rays are sorted by a 24-bit key (direction octant over
an 18-bit origin Morton code) with dead lanes (tmax <= tmin) last; after
it, the results go back to lane order through the lane ids carried by the
sort. Lane order is all the integrator sees, so the wrapper does not
change any estimate: the intersector's result per ray does not depend on
where the ray sits in the batch.

The JAX wrapper falls back to an argsort for ray counts the bitonic
network cannot take; here such a count is padded with dead lanes up to
the next power of two (at least 1024) and goes through the same kernel.
"""

from __future__ import annotations

import torch

from henjou_torch.accel import bitonic
from henjou_torch.utils.timer import span

DEAD_KEY = (1 << 30) - 1


def _part1by2(x):
    """Spread bits of an 8-bit int over every 3rd bit."""
    x = x & 0xFF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def ray_sort_key(ray_o, ray_d, lo, inv_extent):
    """24-bit i32 sort key: 3-bit direction octant (major) over an 18-bit
    origin Morton code (6 bits per axis)."""
    octant = (
        (ray_d[:, 0] >= 0).to(torch.int32)
        | ((ray_d[:, 1] >= 0).to(torch.int32) << 1)
        | ((ray_d[:, 2] >= 0).to(torch.int32) << 2)
    )
    q = torch.clamp((ray_o - lo) * inv_extent, 0.0, 1.0 - 1e-7)
    qi = (q * 64.0).to(torch.int32)  # 6 bits per axis
    morton = (
        (_part1by2(qi[:, 0]) << 2)
        | (_part1by2(qi[:, 1]) << 1)
        | _part1by2(qi[:, 2])
    )
    return (octant << 18) | morton


def make_sorted_intersector(intersect_fn, occluded_fn, lo, hi):
    """Wrap (intersect_fn, occluded_fn) so rays are sorted into coherent
    order before the kernel and results unsorted after, with a stable
    `torch.argsort` of the same key and gathers (the JAX package's
    `make_sorted_intersector`, which runs no Pallas kernel either). Dead
    lanes keep their key. lo/hi: the scene AABB corners ([3] tensors or
    arrays)."""
    lo = torch.as_tensor(lo, dtype=torch.float32)
    inv_extent = 1.0 / torch.clamp(torch.as_tensor(hi, dtype=torch.float32) - lo, min=1e-12)

    def _sorted(fn, closest: bool):
        def wrapped(tri, ray_o, ray_d, tmin, tmax):
            r = ray_o.shape[0]
            dev = ray_o.device
            tmin_b = torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(r)
            tmax_b = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(r)
            key = ray_sort_key(ray_o, ray_d, lo.to(dev), inv_extent.to(dev))
            perm = torch.argsort(key, stable=True)
            out = fn(tri, ray_o[perm], ray_d[perm], tmin_b[perm], tmax_b[perm])
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(r, device=dev)
            if not closest:
                return out[inv]
            return tuple(x[inv] for x in out)

        return wrapped

    return _sorted(intersect_fn, True), _sorted(occluded_fn, False)


def _padded_size(r: int) -> int:
    return max(1024, 1 << max(r - 1, 0).bit_length())


def make_bitonic_sorted_intersector(intersect_fn, occluded_fn, lo, hi,
                                    sort=bitonic.bitonic_sort,
                                    unsort=bitonic.bitonic_unsort):
    """Wrap (intersect_fn, occluded_fn) so rays are sorted into coherent
    order before the kernel and results restored to lane order after.
    lo/hi: the scene AABB corners ([3] tensors). `sort`/`unsort` default
    to the CUDA-backed wrappers; pass `bitonic.bitonic_sort_plain` and
    `bitonic.bitonic_unsort_plain` to run the plain versions."""
    lo = lo.to(torch.float32)
    inv_extent = 1.0 / torch.clamp(hi.to(torch.float32) - lo, min=1e-12)

    def _sorted(fn, closest: bool):
        def wrapped(tri, ray_o, ray_d, tmin, tmax):
            with span("accel.sort"):
                r = ray_o.shape[0]
                dev = ray_o.device
                tmin_b = torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(r)
                tmax_b = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(r)
                # a 0-d tmin is the same for every lane: no sort plane for it
                scalar_tmin = torch.as_tensor(tmin).dim() == 0
                key = ray_sort_key(ray_o, ray_d, lo, inv_extent)
                key = torch.where(tmax_b > tmin_b, key, DEAD_KEY)
                n = _padded_size(r)
                planes = [ray_o, ray_d]
                if not scalar_tmin:
                    planes.append(tmin_b)
                planes.append(tmax_b)
                if n != r:
                    # dead padding lanes: zero origin, +y direction, tmax = 0
                    pad = n - r
                    key = torch.cat([key, torch.full((pad,), DEAD_KEY, dtype=torch.int32,
                                                     device=dev)])
                    fill = [torch.zeros(pad, 3, device=dev),
                            torch.tensor([0.0, 1.0, 0.0], device=dev).expand(pad, 3)]
                    fill += [torch.zeros(pad, device=dev)] * (len(planes) - 2)
                    planes = [torch.cat([p, f.to(p.dtype)]) for p, f in zip(planes, fill)]
                lane = torch.arange(n, dtype=torch.int32, device=dev)
                _, so, sd, *st, lid = sort(key.contiguous(), *[p.contiguous() for p in planes],
                                           lane)
                tn = tmin_b[:1].expand(n) if scalar_tmin else st[0]
            with span("accel.intersect"):
                out = fn(tri, so, sd, tn, st[-1])
            with span("accel.unsort"):
                if not closest:
                    (res,) = unsort(lid, out.to(torch.int32))
                    return res[:r] != 0
                t, prim, u, v, _ = out
                t, prim, u, v = unsort(lid, t, prim, u, v)
                t, prim, u, v = t[:r], prim[:r], u[:r], v[:r]
                return t, prim, u, v, prim >= 0

        return wrapped

    return _sorted(intersect_fn, True), _sorted(occluded_fn, False)
