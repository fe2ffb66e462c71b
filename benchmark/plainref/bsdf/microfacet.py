"""Shared Trowbridge-Reitz (GGX) microfacet math (port of
henjou_tpu/bsdf/microfacet.py). Shading space: +Y = normal."""

from __future__ import annotations

import torch

from plainref.math.constants import PI
from plainref.math.vec import normalize


def ggx_d(wm, alpha):
    """GGX NDF."""
    a2 = alpha * alpha
    term1 = (wm[..., 0] * wm[..., 0] + wm[..., 2] * wm[..., 2]) / a2 + wm[..., 1] * wm[..., 1]
    return 1.0 / (PI * a2 * term1 * term1)


def ggx_lambda(v, alpha):
    """Smith Lambda; v.y == 0 lanes are guarded."""
    y2 = torch.clamp(v[..., 1] * v[..., 1], min=1e-12)
    delta = 1.0 + alpha * alpha * (v[..., 0] * v[..., 0] + v[..., 2] * v[..., 2]) / y2
    return (-1.0 + torch.sqrt(delta)) * 0.5


def ggx_g1(v, alpha):
    return 1.0 / (1.0 + ggx_lambda(v, alpha))


def ggx_g2_height_correlated(wi, wo, alpha):
    return 1.0 / (1.0 + ggx_lambda(wi, alpha) + ggx_lambda(wo, alpha))


def sample_visible_normal(xi, wo, alpha):
    """Spherical-cap VNDF sampling (arXiv 2306.05044). xi: [...,2]
    uniform, wo: shading-space view direction."""
    alpha = torch.as_tensor(alpha, dtype=wo.dtype, device=wo.device).expand(wo.shape[:-1])
    stretch = torch.stack([wo[..., 0] * alpha, wo[..., 1], wo[..., 2] * alpha], dim=-1)
    swo = normalize(stretch)
    phi = 2.0 * PI * xi[..., 0]
    z = (1.0 - xi[..., 1]) * (1.0 + swo[..., 1]) - swo[..., 1]
    sin_t = torch.sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    x = sin_t * torch.cos(phi)
    y = sin_t * torch.sin(phi)
    # cap sample in the reference's (x, z, y) layout with +Y up
    h = torch.stack([x, z, y], dim=-1) + swo
    return normalize(torch.stack([h[..., 0] * alpha, h[..., 1], h[..., 2] * alpha], dim=-1))


def vndf_pdf(wm, wo, alpha):
    """Visible-normal pdf of the reflected direction:
    D * G1(wo) / (4 |wo.y|)."""
    d = ggx_d(wm, alpha)
    g1 = ggx_g1(wo, alpha)
    return 0.25 * d * g1 / torch.clamp(torch.abs(wo[..., 1]), min=1e-12)
