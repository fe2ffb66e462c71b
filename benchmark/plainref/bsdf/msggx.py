"""Multiple-scattering GGX via a microsurface random walk (Heitz 2016).

Port of henjou_tpu/bsdf/msggx.py: uniform height distribution, VNDF phase
function with Schlick weight, at most 5 scattering orders, pdf taken as
|wi.y|. The walk is a fixed 6-iteration masked loop; each lane's CMJ state
advances only while that lane is still walking, so its random stream is
the one the reference's data-dependent loop consumes. A walk that NaNs
returns 0 (the reference returns the colour (0,0,1) there).
"""

from __future__ import annotations

import torch

from plainref.bsdf.microfacet import sample_visible_normal
from plainref.math.vec import dot, schlick_fresnel
from plainref.sampling.cmj import CMJState, cmj_1d, cmj_2d

MAX_SCATTERING_ORDER = 5
_INF = 3.4e38  # FLT_MAX stand-in ("left the microsurface")


def msggx_alpha(roughness):
    return torch.clamp(roughness * roughness, 1e-4, 1.0)


def _c1(h):
    """Uniform height CDF."""
    return torch.clamp(0.5 * (h + 1.0), 0.0, 1.0)


def _inv_c1(u):
    return torch.clamp(2.0 * u - 1.0, -1.0, 1.0)


def _lambda_signed(v, alpha):
    """Signed Smith Lambda, clamped at grazing |v.y| ~ 1."""
    y = v[..., 1]
    y2 = torch.clamp(y * y, min=1e-12)
    delta = 1.0 + alpha * alpha * (v[..., 0] * v[..., 0] + v[..., 2] * v[..., 2]) / y2
    sign = torch.where(y > 0.0, 1.0, -1.0)
    lam = (-1.0 + sign * torch.sqrt(delta)) * 0.5
    lam = torch.where(y > 0.9999, 0.0, lam)
    return torch.where(y < -0.9999, -1.0, lam)


def _g1_height(w, h0, alpha):
    """Directional visibility from height h0."""
    c1 = _c1(h0)
    lam = _lambda_signed(w, alpha)
    val = torch.pow(torch.clamp(c1, min=1e-20), lam)
    val = torch.where(w[..., 1] > 0.9999, 1.0, val)
    return torch.where(w[..., 1] <= 0.0, 0.0, val)


def _sample_height(wr, hr, u, alpha):
    """Conditional height sampling: the next height, or _INF when the ray
    leaves the microsurface."""
    y = wr[..., 1]
    lam = _lambda_signed(wr, alpha)
    g1 = _g1_height(wr, hr, alpha)
    leave = u > (1.0 - g1)
    pow_term = torch.pow(
        torch.clamp(1.0 - u, min=1e-20),
        1.0 / torch.where(torch.abs(lam) > 1e-12, lam, 1e-12),
    )
    h_generic = _inv_c1(_c1(hr) / torch.clamp(pow_term, min=1e-20))
    h = torch.where(leave, _INF, h_generic)
    # special cases, outermost last so they take priority
    h = torch.where(torch.abs(y) < 1e-4, hr, h)  # horizontal ray
    h = torch.where(y < -0.9999, _inv_c1(u * _c1(hr)), h)  # straight down
    return torch.where(y > 0.9999, _INF, h)  # straight up: leaves


def _sel_depth(mask, new: CMJState, old: CMJState) -> CMJState:
    return old._replace(depth=torch.where(mask, new.depth, old.depth))


def msggx_sample(F0, roughness, wo, state: CMJState):
    """Importance sampling by the walk. Returns (bsdf[R,3], wi[R,3],
    pdf[R], state); bsdf is the walk's Fresnel throughput and
    pdf = |wi.y|, so weight/pdf * cos telescopes to the throughput."""
    alpha = msggx_alpha(roughness)
    wr = -wo
    hr = torch.full(wo.shape[:-1], 1.998, dtype=torch.float32, device=wo.device)
    weight = torch.ones_like(wo)
    walking = torch.ones(wo.shape[:-1], dtype=torch.bool, device=wo.device)
    exceeded = torch.zeros_like(walking)
    order = torch.zeros(wo.shape[:-1], dtype=torch.int32, device=wo.device)
    st = state

    for _ in range(MAX_SCATTERING_ORDER + 1):
        u, st_u = cmj_1d(st)
        st = _sel_depth(walking, st_u, st)

        h_new = _sample_height(wr, hr, u, alpha)
        leaves = walking & (h_new >= _INF)
        continues = walking & ~leaves

        order = torch.where(continues, order + 1, order)
        now_exceeded = continues & (order > MAX_SCATTERING_ORDER)
        exceeded = exceeded | now_exceeded
        continues = continues & ~now_exceeded

        # phase-function bounce for lanes still inside the surface
        uv, st_p = cmj_2d(st)
        st = _sel_depth(continues, st_p, st)
        v = -wr
        wm = sample_visible_normal(uv, v, alpha)
        w_out = -v + 2.0 * wm * dot(v, wm)[..., None]
        w1 = schlick_fresnel(F0, v, wm)

        nan_lane = continues & (torch.isnan(h_new) | torch.isnan(w_out[..., 2]))
        exceeded = exceeded | nan_lane
        continues = continues & ~nan_lane

        wr = torch.where(continues[..., None], w_out, wr)
        weight = torch.where(continues[..., None], weight * w1, weight)
        hr = torch.where(continues, h_new, hr)
        walking = continues

    wi = wr  # escape direction
    bad = exceeded | walking | (wi[..., 1] < 0.0)
    up = torch.zeros_like(wi)
    up[..., 2] = 1.0
    wi = torch.where(exceeded[..., None], up, wi)
    bsdf = torch.where(bad[..., None], 0.0, weight)
    pdf = torch.where(bad, 1.0, torch.clamp(torch.abs(wi[..., 1]), min=1e-12))
    return bsdf, wi, pdf, st
