"""Batched 3D shading math over [..., 3] tensors.

Port of henjou_tpu/math/vec.py. Shading space has the surface normal as
the local +Y axis (wo.y == cos(theta)). Dot products are written out
component by component, ((x + y) + z), so their rounding does not depend
on how a library reduction orders the sum.
"""

from __future__ import annotations

import torch

from plainref.math.constants import PI


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the last axis; keeps no dims."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def absdot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def norm2(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(norm2(v))


def normalize(v, eps: float = 1e-20):
    return v * (1.0 / torch.sqrt(torch.clamp(norm2(v), min=eps)))[..., None]


def pow5(x):
    """x**5 as XLA's integer power computes it: x * ((x*x) * (x*x))."""
    x2 = x * x
    return x * (x2 * x2)


def reflect(v, n):
    """r = v - 2*dot(v, n)*n (reflect(-wo, m) mirrors wo about m)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v, n, ior1, ior2):
    """Snell refraction of `v` (pointing away from the surface) about `n`
    from ior1 into ior2. Returns (ok, r); ok=False marks total internal
    reflection lanes."""
    eta = ior1 / ior2
    t_h = -eta[..., None] * (v - dot(v, n)[..., None] * n)
    sin2 = norm2(t_h)
    ok = sin2 <= 1.0
    t_p = -torch.sqrt(torch.clamp(1.0 - sin2, min=0.0))[..., None] * n
    return ok, t_h + t_p


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def step(a, x):
    return (a < x).to(torch.float32)


def schlick_fresnel(F0, w, n):
    """Schlick approximation with an RGB F0."""
    term1 = 1.0 - dot(w, n)
    return (1.0 - F0) * pow5(term1)[..., None] + F0


def schlick_fresnel_ior(no, ni, w, n):
    """Scalar Schlick from a pair of IORs."""
    F0 = (no - ni) / (no + ni)
    F0 = F0 * F0
    term1 = 1.0 - dot(w, n)
    return F0 + (1.0 - F0) * pow5(term1)


def orthonormal_basis(n):
    """Branchless ONB (Duff et al. 2017). Returns (tangent, binormal)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    tangent = torch.stack(
        [
            1.0 + sign * n[..., 0] * n[..., 0] * a,
            sign * b,
            -sign * n[..., 0],
        ],
        dim=-1,
    )
    binormal = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return tangent, binormal


def world_to_local(v, t, n, b):
    """World direction -> shading-local (t, n, b) with n as +Y."""
    return torch.stack([dot(v, t), dot(v, n), dot(v, b)], dim=-1)


def local_to_world(v, t, n, b):
    return v[..., 0:1] * t + v[..., 1:2] * n + v[..., 2:3] * b


def cosine_sampling(u, v):
    """Cosine-weighted hemisphere sample (local +Y up) and its pdf, with the
    reference's theta = 0.5*acos(1-2u). Returns (wi[..., 3], pdf[...])."""
    phi = 2.0 * PI * v
    theta = 0.5 * torch.arccos(torch.clamp(1.0 - 2.0 * u, -1.0, 1.0))
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    wi = torch.stack([torch.cos(phi) * sin_t, cos_t, torch.sin(phi) * sin_t], dim=-1)
    return wi, cos_t / PI


def transform_position(mat, pos):
    """Apply a row-major [..., 3, 4] affine to points."""
    return (mat[..., :3, :3] * pos[..., None, :]).sum(dim=-1) + mat[..., :3, 3]


def transform_normal(inv_mat, n):
    """Transform a normal by the inverse-transpose: pass the INVERSE
    affine; this applies its 3x3 transpose."""
    return (inv_mat[..., :3, :3] * n[..., :, None]).sum(dim=-2)
