"""Disney principled BRDF (port of henjou_tpu/bsdf/disney.py).

Lobes: diffuse + subsurface blend, GGX specular with
F0 = lerp(0.08, basecolor, metallic), sheen, fixed-gloss clearcoat, and the
thin-film branch that replaces the specular F0 with a LUT lookup keyed on
(thickness = basecolor.x, cos theta). alpha = clamp(roughness^2, 0.01, 1);
subsurface is 0 and clearcoatGloss 1, as in the reference constructor.

Deviation kept from the JAX package: the reference computes `dot_wo_n`
from wi (disneyBRDF.h:189); this uses |wo.y|.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from plainref.bsdf.microfacet import (
    ggx_d,
    ggx_g2_height_correlated,
    sample_visible_normal,
    vndf_pdf,
)
from plainref.math.constants import INV_PI, PI, PI2
from plainref.math.vec import absdot, lerp, normalize, pow5, reflect, schlick_fresnel
from plainref.sampling.cmj import CMJState, cmj_1d, cmj_2d

_CLEARCOAT_GLOSS = 1.0
_CLEARCOAT_ALPHA = 0.1 * (1.0 - _CLEARCOAT_GLOSS) + 0.001 * _CLEARCOAT_GLOSS
# PI * log(alpha^2) of the clearcoat NDF, computed in f32 as the JAX
# package does, held as a Python float
_CLEARCOAT_PI_LOG_A2 = float(
    torch.tensor(PI, dtype=torch.float32)
    * torch.log(torch.tensor(_CLEARCOAT_ALPHA * _CLEARCOAT_ALPHA, dtype=torch.float32))
)


class DisneyParams(NamedTuple):
    basecolor: torch.Tensor  # [R,3]
    alpha: torch.Tensor  # [R]
    metallic: torch.Tensor  # [R]
    sheen: torch.Tensor  # [R]
    clearcoat: torch.Tensor  # [R]
    subsurface: torch.Tensor  # [R]
    is_thinfilm: torch.Tensor  # [R] bool


def disney_params(basecolor, roughness, metallic, sheen, clearcoat,
                  is_thinfilm=None) -> DisneyParams:
    if is_thinfilm is None:
        is_thinfilm = torch.zeros(roughness.shape, dtype=torch.bool, device=roughness.device)
    return DisneyParams(
        basecolor=basecolor,
        alpha=torch.clamp(roughness * roughness, 0.01, 1.0),
        metallic=metallic,
        sheen=sheen,
        clearcoat=clearcoat,
        subsurface=torch.zeros_like(roughness),
        is_thinfilm=is_thinfilm,
    )


def _f_t_schlick(wn, f90):
    delta = torch.clamp(1.0 - wn, min=0.0)
    return 1.0 + (f90 - 1.0) * pow5(delta)


def _clearcoat_d(wm):
    """Log-normalized clearcoat NDF at the fixed clearcoat alpha."""
    a2 = _CLEARCOAT_ALPHA * _CLEARCOAT_ALPHA
    t = 1.0 + (a2 - 1.0) * (wm[..., 1] * wm[..., 1])
    return (a2 - 1.0) / (_CLEARCOAT_PI_LOG_A2 * t)


def _clearcoat_lambda(w, alpha):
    y2 = torch.clamp(w[..., 1] * w[..., 1], min=1e-12)
    term1 = 1.0 + alpha * alpha * (w[..., 0] * w[..., 0] + w[..., 2] * w[..., 2]) / y2
    return 0.5 * (-1.0 + torch.sqrt(term1))


def _clearcoat_g2(wi, wo, alpha):
    return 1.0 / (1.0 + _clearcoat_lambda(wi, alpha) + _clearcoat_lambda(wo, alpha))


def _pdf_diffuse(wi):
    return torch.abs(wi[..., 1]) * INV_PI


def _specular_f0(p: DisneyParams, wi, wm, lut: Optional[torch.Tensor]):
    """F0 = lerp(0.08, basecolor, metallic), or the thin-film LUT."""
    f0 = lerp(torch.full_like(p.basecolor, 0.08), p.basecolor, p.metallic[..., None])
    if lut is not None:
        from plainref.texture.lut import sample_lut

        f0_film = sample_lut(lut, p.basecolor[..., 0], absdot(wi, wm))
        f0 = torch.where(p.is_thinfilm[..., None], f0_film, f0)
    return f0


def disney_eval(p: DisneyParams, wo, wi, lut: Optional[torch.Tensor] = None,
                has_sheen: bool = True, has_clearcoat: bool = True):
    """has_sheen/has_clearcoat are scene facts: zero-weight terms are
    skipped."""
    wm = normalize(wo + wi)
    dot_wi_n = torch.abs(wi[..., 1])
    dot_wo_n = torch.abs(wo[..., 1])

    cosine_d = absdot(wi, wm)
    f_d90 = 0.5 + 2.0 * p.alpha * cosine_d * cosine_d

    f_tsi = _f_t_schlick(dot_wi_n, f_d90)
    f_tso = _f_t_schlick(dot_wo_n, f_d90)

    f_diffuse = p.basecolor * (f_tsi * f_tso * INV_PI)[..., None]

    deltacos = 1.0 / torch.clamp(dot_wi_n + dot_wo_n, min=1e-6) - 0.5
    f_subsurface = p.basecolor * (INV_PI * 1.25 * (f_tsi * f_tso * deltacos + 0.5))[..., None]

    f0 = _specular_f0(p, wi, wm, lut)
    d = ggx_d(wm, p.alpha)
    g2 = ggx_g2_height_correlated(wi, wo, p.alpha)
    f = schlick_fresnel(f0, wo, wm)
    f_specular = 0.25 * (d * g2 / torch.clamp(dot_wo_n * dot_wi_n, min=1e-9))[..., None] * f

    diffuse_blend = lerp(f_diffuse, f_subsurface, p.subsurface[..., None])
    out = diffuse_blend * (1.0 - p.metallic[..., None]) + f_specular

    if has_sheen:
        delta = torch.clamp(1.0 - cosine_d, min=0.0)
        f_sheen = (p.sheen * pow5(delta))[..., None] * torch.ones_like(p.basecolor)
        out = out + f_sheen * (1.0 - p.metallic[..., None])

    if has_clearcoat:
        ccd = _clearcoat_d(wm)
        ccg = _clearcoat_g2(wi, wo, 0.25)
        ccf = schlick_fresnel(torch.full_like(f0, 0.04), wo, wm)
        f_clearcoat = (
            0.25 * (ccd * ccg / torch.clamp(dot_wo_n * dot_wi_n, min=1e-9))[..., None] * ccf
        ) * 0.25
        out = out + f_clearcoat * p.clearcoat[..., None]
    return out


def _lobe_weights(p: DisneyParams):
    """Lobe weights: diffuse 1-metallic, specular 0.5, clearcoat 0."""
    dw = 1.0 - p.metallic
    sw = torch.full_like(dw, 0.5)
    cw = torch.zeros_like(dw)
    total = dw + sw + cw
    return dw / total, sw / total, cw / total


def _sample_diffuse(xi):
    """Cosine sampling with the reference's exact construction."""
    theta = 0.5 * torch.arccos(torch.clamp(1.0 - 2.0 * xi[..., 0], -1.0, 1.0))
    phi = PI2 * xi[..., 1]
    ct = torch.cos(theta)
    st = torch.sin(theta)
    return torch.stack([torch.cos(phi) * st, ct, torch.sin(phi) * st], dim=-1)


def disney_sample(p: DisneyParams, wo, state: CMJState,
                  lut: Optional[torch.Tensor] = None, has_sheen: bool = True,
                  has_clearcoat: bool = True):
    """Lobe-mixture sampling, branch-free: one 1D and one 2D draw per lane
    on every branch (the reference's clearcoat sampling branch is dead,
    its weight is 0). Returns (bsdf[R,3], wi[R,3], pdf[R], state)."""
    dw, sw, _cw = _lobe_weights(p)
    select_p, state = cmj_1d(state)
    xi, state = cmj_2d(state)

    wi_diff = _sample_diffuse(xi)
    wm_spec = sample_visible_normal(xi, wo, p.alpha)
    wi_spec = reflect(-wo, wm_spec)

    take_diffuse = select_p < dw
    wi = torch.where(take_diffuse[..., None], wi_diff, wi_spec)
    wm = normalize(wo + wi)

    pdf = dw * _pdf_diffuse(wi) + sw * vndf_pdf(wm, wo, p.alpha)

    below = wi[..., 1] < 0.0
    bsdf = disney_eval(p, wo, wi, lut, has_sheen, has_clearcoat)
    bsdf = torch.where(below[..., None], 0.0, bsdf)
    pdf = torch.where(below, 1.0, pdf)
    return bsdf, wi, pdf, state


def disney_pdf(p: DisneyParams, wo, wi):
    """MIS pdf: the diffuse + specular mixture."""
    dw, sw, _ = _lobe_weights(p)
    wm = normalize(wo + wi)
    return dw * _pdf_diffuse(wi) + sw * vndf_pdf(wm, wo, p.alpha)
