"""FastMultipleGGX: single-scatter GGX plus a cheap analytic
multiple-scattering compensation term (port of henjou_tpu/bsdf/fastggx.py).

A GGX lobe with VNDF sampling, plus a compensation term about the
half-centroid direction: centroid-direction shadowing (`_multiple_g`) and
an approximate NDF at the half-centroid angle (`_ggx_d_approx`). The
reference builds this BSDF but leaves its sample path commented out; as in
the JAX package, no dispatch routes it.
"""

from __future__ import annotations

import torch

from henjou_torch.bsdf.ggx import ggx_alpha
from henjou_torch.bsdf.microfacet import (
    ggx_d,
    ggx_g1,
    ggx_g2_height_correlated,
    sample_visible_normal,
)
from henjou_torch.math.constants import PI
from henjou_torch.math.vec import absdot, dot, normalize, reflect, schlick_fresnel
from henjou_torch.sampling.cmj import CMJState, cmj_2d


def _multiple_g(wo, wi, wc):
    """Centroid-direction shadowing of the compensation lobe."""
    theta_c = torch.arccos(torch.clamp(dot(wo, wc), -1.0, 1.0))
    theta_m = (PI - torch.arccos(torch.clamp(dot(wo, wi), -1.0, 1.0))) * 0.25
    op = torch.sin(theta_c - theta_m) / torch.clamp(torch.sin(theta_c + theta_m), min=1e-6)
    return 1.0 - torch.clamp(op, min=0.0)


def _ggx_d_approx(mdot, alpha):
    a2 = alpha * alpha
    term1 = mdot * mdot * (a2 - 1.0) + 1.0
    return a2 / (PI * term1 * term1)


def _single_scatter(F0, wo, wi, wm, alpha):
    d = ggx_d(wm, alpha)
    g2 = ggx_g2_height_correlated(wi, wo, alpha)
    f = schlick_fresnel(F0, wi, wm)
    denom = 4.0 * wo[..., 1] * wi[..., 1]
    return (d * g2 / torch.where(torch.abs(denom) > 1e-12, denom, 1e-12))[..., None] * f, d, f


def fast_ggx_eval(F0, roughness, wo, wi):
    """The single-scatter part only."""
    alpha = ggx_alpha(roughness)
    return _single_scatter(F0, wo, wi, normalize(wo + wi), alpha)[0]


def fast_ggx_sample(F0, roughness, wo, state: CMJState):
    """VNDF sample plus the analytic multiple-scattering compensation.
    Returns (bsdf[R,3], wi[R,3], pdf[R], state)."""
    alpha = ggx_alpha(roughness)
    xi, state = cmj_2d(state)
    wm = sample_visible_normal(xi, wo, alpha)
    wi = reflect(-wo, wm)
    below = wi[..., 1] <= 0.0
    bsdf, d, f = _single_scatter(F0, wo, wi, wm, alpha)

    jac = 0.25 / torch.clamp(absdot(wo, wm), min=1e-12)
    g1 = ggx_g1(wo, alpha)
    pdf = d * g1 * absdot(wo, wm) * jac / torch.clamp(torch.abs(wo[..., 1]), min=1e-12)

    # the compensation lobe about the half-centroid direction
    up = torch.zeros_like(wm)
    up[..., 1] = 1.0
    wc = normalize(up + wm)
    gi = _multiple_g(wo, wi, wc)
    theta_m = (PI - torch.arccos(torch.clamp(dot(wo, wi), -1.0, 1.0))) * 0.25
    di = _ggx_d_approx(torch.cos(theta_m), alpha)
    bsdf = bsdf + (di * gi / torch.clamp(2.0 * dot(wc, wo), min=1e-6))[..., None] * f * f

    bsdf = torch.where(below[..., None], 0.0, bsdf)
    pdf = torch.where(below, 1.0, pdf)
    return bsdf, wi, pdf, state
