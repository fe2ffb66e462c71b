"""BSDF facade: per-hit lobe dispatch (port of henjou_tpu/bsdf/dispatch.py).

Routing:
- ideal_specular        -> MetaMaterialGlass
- else metallic > 0.5   -> multiple-scattering GGX
- else                  -> Disney
eval/pdf route to glass-or-Disney only.

Every lane computes each lobe's sample from the same input sampler state;
outputs and the advanced sampler state are then selected by category, so
each lane's random stream advances exactly as if only its branch had run.
The has_* flags are scene facts: lobes no material uses are skipped.
"""

from __future__ import annotations

from typing import Optional

import torch

from plainref.bsdf.disney import DisneyParams, disney_eval, disney_params, disney_pdf, disney_sample
from plainref.bsdf.glass import glass_eval, glass_pdf, meta_glass_sample
from plainref.bsdf.msggx import msggx_sample
from plainref.sampling.cmj import CMJState


def _params_from_hit(hit) -> DisneyParams:
    return disney_params(
        basecolor=hit.basecolor,
        roughness=hit.roughness,
        metallic=hit.metallic,
        sheen=hit.sheen,
        clearcoat=hit.clearcoat,
        is_thinfilm=hit.is_thinfilm,
    )


def _sel_state(mask, a: CMJState, b: CMJState) -> CMJState:
    return b._replace(depth=torch.where(mask, a.depth, b.depth))


def bsdf_sample(hit, local_wo, state: CMJState, lut: Optional[torch.Tensor] = None,
                has_specular: bool = True, has_metal: bool = True,
                has_sheen: bool = True, has_clearcoat: bool = True):
    """Returns (bsdf[R,3], wi[R,3], pdf[R], state)."""
    p = _params_from_hit(hit)
    bsdf, wi, pdf, st = disney_sample(p, local_wo, state, lut, has_sheen, has_clearcoat)

    if has_metal:
        is_ggx = hit.metallic > 0.5
        b_ms, wi_ms, pdf_ms, st_ms = msggx_sample(hit.basecolor, hit.roughness, local_wo, state)
        ggx = is_ggx[..., None]
        bsdf = torch.where(ggx, b_ms, bsdf)
        wi = torch.where(ggx, wi_ms, wi)
        pdf = torch.where(is_ggx, pdf_ms, pdf)
        st = _sel_state(is_ggx, st_ms, st)

    if has_specular:
        is_spec = hit.is_specular
        b_glass, wi_glass, pdf_glass, st_glass = meta_glass_sample(
            torch.ones_like(hit.basecolor), hit.ior, local_wo, state
        )
        spec = is_spec[..., None]
        bsdf = torch.where(spec, b_glass, bsdf)
        wi = torch.where(spec, wi_glass, wi)
        pdf = torch.where(is_spec, pdf_glass, pdf)
        st = _sel_state(is_spec, st_glass, st)

    return bsdf, wi, pdf, st


def bsdf_eval(hit, local_wo, local_wi, lut: Optional[torch.Tensor] = None,
              has_sheen: bool = True, has_clearcoat: bool = True):
    """Glass lanes are delta (0); everything else evaluates Disney,
    metals included, as the reference does for NEE."""
    p = _params_from_hit(hit)
    val = disney_eval(p, local_wo, local_wi, lut, has_sheen, has_clearcoat)
    return torch.where(hit.is_specular[..., None], glass_eval(local_wo, local_wi), val)


def bsdf_pdf(hit, local_wo, local_wi):
    p = _params_from_hit(hit)
    val = disney_pdf(p, local_wo, local_wi)
    return torch.where(hit.is_specular, glass_pdf(local_wo, local_wi), val)


def make_bsdf_sampler(lut: Optional[torch.Tensor] = None, has_specular: bool = True,
                      has_metal: bool = True, has_sheen: bool = True,
                      has_clearcoat: bool = True):
    """Closure matching the integrator's bsdf_sample signature."""

    def sampler(hit, local_wo, state):
        return bsdf_sample(
            hit, local_wo, state, lut,
            has_specular=has_specular, has_metal=has_metal,
            has_sheen=has_sheen, has_clearcoat=has_clearcoat,
        )

    return sampler
