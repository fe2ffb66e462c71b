"""Lambert BSDF (port of henjou_tpu/bsdf/lambert.py).

All BSDFs here share one convention: directions in shading space
(+Y = normal), batched over rays, sampling threads the CMJ state."""

from __future__ import annotations

from plainref.math.constants import INV_PI
from plainref.math.vec import cosine_sampling
from plainref.sampling.cmj import CMJState, cmj_2d


def lambert_sample(basecolor, wo, state: CMJState):
    """Returns (bsdf[R,3], wi[R,3], pdf[R], state)."""
    xi, state = cmj_2d(state)
    wi, pdf = cosine_sampling(xi[..., 0], xi[..., 1])
    return basecolor * INV_PI, wi, pdf, state

