"""Smooth dielectric BSDFs: IdealGlass and the minus-IOR MetaMaterialGlass
(port of henjou_tpu/bsdf/glass.py).

MetaMaterialGlass mirrors the refracted ray about the inverted normal,
(t.x, t.y, t.z) -> (-t.x, t.y, -t.z). Both are delta lobes: eval and pdf
are 0, so NEE skips them and MIS treats them as specular.
"""

from __future__ import annotations

import torch

from plainref.math.vec import reflect, refract, schlick_fresnel_ior
from plainref.sampling.cmj import CMJState, cmj_1d


def _glass_sample(rho, ior, wo, state: CMJState, meta: bool):
    """Branch-free IdealGlass/MetaMaterialGlass sampling: entering
    (wo.y >= 0) goes 1 -> ior, leaving ior -> 1 with the local frame
    flipped; Fresnel selects reflect or refract, and total internal
    reflection falls back to reflect. Returns (bsdf, wi, pdf, state)."""
    leaving = wo[..., 1] < 0.0
    ior_o = torch.where(leaving, ior, 1.0)
    ior_i = torch.where(leaving, 1.0, ior)
    sign = torch.where(leaving, -1.0, 1.0)
    flip = torch.stack([torch.ones_like(sign), sign, torch.ones_like(sign)], dim=-1)
    lwo = wo * flip

    n = torch.zeros_like(wo)
    n[..., 1] = 1.0
    fr = schlick_fresnel_ior(ior_o, ior_i, lwo, n)

    p, state = cmj_1d(state)

    refl = reflect(-lwo, n)
    ok, trans = refract(lwo, n, ior_o, ior_i)
    if meta:
        # mirror across the inverted normal: (x, y, z) -> (-x, y, -z)
        trans = torch.stack([-trans[..., 0], trans[..., 1], -trans[..., 2]], dim=-1)

    take_reflect = (p < fr) | ~ok
    lwi = torch.where(take_reflect[..., None], refl, trans)

    pdf = torch.ones(wo.shape[:-1], dtype=torch.float32, device=wo.device)
    absy = torch.clamp(torch.abs(lwi[..., 1]), min=1e-12)
    bsdf = torch.as_tensor(rho, dtype=torch.float32, device=wo.device).expand(wo.shape) / absy[..., None]
    return bsdf, lwi * flip, pdf, state


def meta_glass_sample(rho, ior, wo, state: CMJState):
    """The facade's specular lobe."""
    return _glass_sample(rho, ior, wo, state, meta=True)


def glass_eval(wo, wi):
    """Delta lobe: zero everywhere."""
    return torch.zeros_like(wo)


def glass_pdf(wo, wi):
    """Delta lobe: zero."""
    return torch.zeros(wo.shape[:-1], dtype=torch.float32, device=wo.device)
