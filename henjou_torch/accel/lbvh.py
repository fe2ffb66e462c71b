"""Morton codes of triangle centroids (port of `_expand_bits` and
`morton_codes` from henjou_tpu/accel/lbvh.py).

`accel/pallas_cluster.py`'s `pack_clusters` orders triangles by these
codes before it cuts them into 128-triangle clusters. The LBVH build and
its traversal stay unported: they are only the JAX package's CPU fallback
(ROADMAP "Not to port"), and the port's CPU path is each kernel's plain
version.

u32 values are held in int64 tensors. The inputs are at most 10 bits, so
every product stays far inside int64, and each mask, which has no bit
above bit 31, keeps exactly the bits the JAX code's wrapping uint32
arithmetic keeps.
"""

from __future__ import annotations

import torch

_MORTON_BITS = 10  # per axis -> 30-bit codes


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so there are 2 zeros between each
    (standard Morton interleave)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(centroids: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """30-bit Morton codes (int64) for [T,3] f32 points within AABB (lo, hi)."""
    extent = torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp((centroids - lo) / extent, 0.0, 1.0 - 1e-7)
    scaled = (q * (1 << _MORTON_BITS)).to(torch.int64)
    scaled = torch.clamp(scaled, max=(1 << _MORTON_BITS) - 1)
    x = _expand_bits(scaled[:, 0])
    y = _expand_bits(scaled[:, 1])
    z = _expand_bits(scaled[:, 2])
    return (x << 2) | (y << 1) | z
