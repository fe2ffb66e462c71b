"""AOV-guided denoiser and 2x upscalers (port of henjou_tpu/post/denoise.py).

Edge-avoiding à-trous wavelet filtering (Dammertz 2010) with albedo,
normal and colour edge stops; its variance-guided (SVGF) form; temporal
reprojection, blending and pre-filter accumulation; a joint-bilateral and
a bilinear 2x upscale. Every function takes [H,W,C] (or [H,W]) float32
tensors and runs on their device as plain tensor ops: it is stencil math
with no kernel of its own in the reference either. Each follows the
reference's order of operations, so CPU results match the JAX functions
to float32 rounding (`denoise_atrous_var` drops the reference's unused
sum of squared weights).

An edge-clamped shift of an image is read as a slice of one
edge-replicated copy (`_pad_edge`, `_tap`): the same values as
`_shift2d`'s clamped gather, without a gather per tap.
"""

from __future__ import annotations

import torch

# 5x5 B3-spline kernel (separable weights 1/16, 1/4, 3/8, 1/4, 1/16)
_H = (1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16)
_LUM = (0.2126, 0.7152, 0.0722)


def _shift2d(img, dy: int, dx: int):
    """Edge-clamped shift of [H,W,C]."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


def _pad_edge(img, p: int):
    """[H+2p, W+2p, ...] edge-replicated copy of `img` (any p >= 0)."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.clamp(torch.arange(-p, h + p, device=img.device), 0, h - 1)
    xs = torch.clamp(torch.arange(-p, w + p, device=img.device), 0, w - 1)
    return img[ys][:, xs]


def _tap(padded, p: int, dy: int, dx: int, h: int, w: int):
    """`_shift2d(img, dy, dx)` read from `_pad_edge(img, p)`, |dy|, |dx| <= p."""
    return padded[p + dy: p + dy + h, p + dx: p + dx + w]


def _luma(c):
    return _LUM[0] * c[..., 0:1] + _LUM[1] * c[..., 1:2] + _LUM[2] * c[..., 2:3]


def denoise_atrous(color, albedo, normal, iterations: int = 4, sigma_color: float = 0.35,
                   sigma_albedo: float = 0.15, sigma_normal: float = 0.25):
    """color/albedo/normal: [H,W,3] f32 -> denoised [H,W,3]."""
    h, w = color.shape[0], color.shape[1]
    big = 2 << max(iterations - 1, 0)
    alb_p, nrm_p = _pad_edge(albedo, big), _pad_edge(normal, big)
    out = color
    for it in range(iterations):
        step = 1 << it
        out_p = _pad_edge(out, 2 * step)
        acc = torch.zeros_like(out)
        wsum = torch.zeros(out.shape[:2] + (1,), dtype=out.dtype, device=out.device)
        for ky in range(5):
            for kx in range(5):
                dy = (ky - 2) * step
                dx = (kx - 2) * step
                w_k = _H[ky] * _H[kx]
                c_s = _tap(out_p, 2 * step, dy, dx, h, w)
                a_s = _tap(alb_p, big, dy, dx, h, w)
                n_s = _tap(nrm_p, big, dy, dx, h, w)
                dc = torch.sum((c_s - out) ** 2, dim=-1, keepdim=True)
                da = torch.sum((a_s - albedo) ** 2, dim=-1, keepdim=True)
                dn = torch.sum((n_s - normal) ** 2, dim=-1, keepdim=True)
                wt = (
                    w_k
                    * torch.exp(-dc / (sigma_color * sigma_color))
                    * torch.exp(-da / (sigma_albedo * sigma_albedo))
                    * torch.exp(-dn / (sigma_normal * sigma_normal))
                )
                acc = acc + c_s * wt
                wsum = wsum + wt
        out = acc / torch.clamp(wsum, min=1e-8)
    return out


def denoise_atrous_var(color, albedo, normal, variance, iterations: int = 4,
                       sigma_lum: float = 1.5, sigma_albedo: float = 0.15,
                       sigma_normal: float = 0.25, demodulate: bool = True,
                       pairwise: bool = False):
    """Variance-guided edge-avoiding à-trous (the SVGF weighting, Schied
    2017): the luminance edge stop is normalised by the per-pixel noise
    level sqrt(var); `variance` [H,W] is the engine's variance-of-the-mean
    AOV, filtered alongside the colour with squared weights.

    `demodulate=True` filters illumination (colour / first-hit albedo) and
    re-modulates afterwards; pixels with near-zero albedo pass through
    unmodulated. `pairwise=True` makes the luminance edge stop symmetric:
    sqrt((var_p + var_s) / 2) instead of sqrt(var_p)."""
    h, w = color.shape[0], color.shape[1]
    alb_d = None
    if demodulate:
        alb_d = torch.where(albedo > 1e-3, albedo, 1.0)
        color = color / alb_d
        # the variance column tracks the modulated luminance: rescale it to
        # the illumination domain
        lum_a = _LUM[0] * alb_d[..., 0] + _LUM[1] * alb_d[..., 1] + _LUM[2] * alb_d[..., 2]
        variance = variance / torch.clamp(lum_a * lum_a, min=1e-6)
    out = color
    var = torch.clamp(variance, min=0.0)[..., None]

    # 3x3 pre-blur of the variance estimate (itself noisy at low spp)
    var_p = _pad_edge(var, 1)
    acc = torch.zeros_like(var)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            wt = (2 - abs(dy)) * (2 - abs(dx)) / 16.0
            acc = acc + wt * _tap(var_p, 1, dy, dx, h, w)
    var = acc

    big = 2 << max(iterations - 1, 0)
    alb_p, nrm_p = _pad_edge(albedo, big), _pad_edge(normal, big)
    for it in range(iterations):
        step = 1 << it
        p = 2 * step
        out_p, var_p = _pad_edge(out, p), _pad_edge(var, p)
        acc = torch.zeros_like(out)
        vacc = torch.zeros_like(var)
        wsum = torch.zeros(out.shape[:2] + (1,), dtype=out.dtype, device=out.device)
        lum = _luma(out)
        denom = sigma_lum * torch.sqrt(var) + 1e-4
        for ky in range(5):
            for kx in range(5):
                dy = (ky - 2) * step
                dx = (kx - 2) * step
                w_k = _H[ky] * _H[kx]
                c_s = _tap(out_p, p, dy, dx, h, w)
                v_s = _tap(var_p, p, dy, dx, h, w)
                a_s = _tap(alb_p, big, dy, dx, h, w)
                n_s = _tap(nrm_p, big, dy, dx, h, w)
                l_s = _luma(c_s)
                if pairwise:
                    # std of the difference of two independent estimates;
                    # /sqrt(2) keeps the uniform case on sigma_lum's scale
                    denom = sigma_lum * torch.sqrt((var + v_s) * 0.5) + 1e-4
                dl = torch.abs(l_s - lum)
                da = torch.sum((a_s - albedo) ** 2, dim=-1, keepdim=True)
                dn = torch.sum((n_s - normal) ** 2, dim=-1, keepdim=True)
                wt = (
                    w_k
                    * torch.exp(-dl / denom)
                    * torch.exp(-da / (sigma_albedo * sigma_albedo))
                    * torch.exp(-dn / (sigma_normal * sigma_normal))
                )
                acc = acc + c_s * wt
                vacc = vacc + v_s * wt * wt
                wsum = wsum + wt
        out = acc / torch.clamp(wsum, min=1e-8)
        var = vacc / torch.clamp(wsum * wsum, min=1e-12)
    if alb_d is not None:
        out = out * alb_d
    return out


def _maxpool3(img):
    """3x3 max pool of [H,W,C], edge-replicated: the neighbourhood bound
    of the TAA-style history clamp (min via -_maxpool3(-img))."""
    h, w = img.shape[0], img.shape[1]
    p = _pad_edge(img, 1)
    out = img
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out = torch.maximum(out, p[dy: dy + h, dx: dx + w])
    return out


def _box3(img):
    """3x3 box mean of [H,W], edge-replicated: a low-noise local reference
    (noise variance var/9) for the temporal luminance gate."""
    h, w = img.shape[0], img.shape[1]
    p = _pad_edge(img, 1)
    out = torch.zeros_like(img)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out = out + p[dy: dy + h, dx: dx + w]
    return out / 9.0


def _guide_weight(albedo, normal, prev_albedo, prev_normal, sigma_albedo, sigma_normal):
    da = torch.sum((albedo - prev_albedo) ** 2, dim=-1, keepdim=True)
    dn = torch.sum((normal - prev_normal) ** 2, dim=-1, keepdim=True)
    return (torch.exp(-da / (sigma_albedo * sigma_albedo)),
            torch.exp(-dn / (sigma_normal * sigma_normal)))


def _bilinear_sample(img, px, py):
    """Bilinear sample of [H,W,C] at continuous pixel coordinates px[H,W],
    py[H,W] (pixel centres: (0.5, 0.5) is texel (0, 0)). Returns ([H,W,C],
    in_bounds[H,W,1])."""
    h, w = img.shape[0], img.shape[1]
    x = px - 0.5
    y = py - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    inb = (px >= 0.0) & (px <= w) & (py >= 0.0) & (py <= h)
    x0c = torch.clamp(x0, 0, w - 1).long()
    y0c = torch.clamp(y0, 0, h - 1).long()
    x1c = torch.clamp(x0 + 1, 0, w - 1).long()
    y1c = torch.clamp(y0 + 1, 0, h - 1).long()
    a = img[y0c, x0c]
    b = img[y0c, x1c]
    c = img[y1c, x0c]
    d = img[y1c, x1c]
    out = (a * (1 - fx) + b * fx) * (1 - fy) + (c * (1 - fx) + d * fx) * fy
    return out, inb[..., None]


def denoise_temporal_reprojected(color, albedo, normal, prev_output, prev_albedo,
                                 prev_normal, px, py, reproject_valid, alpha: float = 0.8,
                                 sigma_albedo: float = 0.1, sigma_normal: float = 0.2,
                                 spatial=None):
    """Temporal blend with motion-compensated history: px/py [H,W] are each
    pixel's first hit projected into the previous camera
    (camera.project_to_pixel), reproject_valid [H,W] marks a hit in front
    of it. History is warped bilinearly, clamped to the 3x3 range of the
    current spatial estimate, and blended where the warped guides agree."""
    if spatial is None:
        spatial = denoise_atrous(color, albedo, normal)
    hist, inb = _bilinear_sample(prev_output, px, py)
    pa, _ = _bilinear_sample(prev_albedo, px, py)
    pn, _ = _bilinear_sample(prev_normal, px, py)
    nmin = -_maxpool3(-spatial)
    nmax = _maxpool3(spatial)
    hist = torch.clamp(hist, nmin, nmax)
    ea, en = _guide_weight(albedo, normal, pa, pn, sigma_albedo, sigma_normal)
    ok = inb * reproject_valid[..., None].to(color.dtype)
    w_hist = alpha * ok * ea * en
    return spatial * (1.0 - w_hist) + hist * w_hist


def temporal_accumulate(color, variance, count, albedo, normal, prev_color, prev_var,
                        prev_count, prev_albedo, prev_normal, px, py, reproject_valid,
                        cap: float = 4.0, sigma_albedo: float = 0.1,
                        sigma_normal: float = 0.2):
    """SVGF-style pre-filter temporal integration (Schied 2017 §4.1): merge
    the motion-compensated previous frame's raw accumulated colour into the
    current raw mean before the spatial filter.

    color [H,W,3], variance [H,W] (of the mean) and count [H,W] are the
    current film's; prev_* the banked history (prev_count the effective
    count, which grows up to the cap). mu = (n_c*cur + n_h*hist)/(n_c+n_h)
    with n_h = gate * min(prev_count, cap*n_c); the warped history is
    clamped to the current 3x3 range widened by the pixel's noise sigma,
    and gated by the guides and a noise-normalised luminance test.
    Returns (merged_color [H,W,3], merged_var [H,W], n_eff [H,W])."""
    hist, inb = _bilinear_sample(prev_color, px, py)
    pv, _ = _bilinear_sample(prev_var[..., None], px, py)
    pc, _ = _bilinear_sample(prev_count[..., None], px, py)
    pa, _ = _bilinear_sample(prev_albedo, px, py)
    pn, _ = _bilinear_sample(prev_normal, px, py)
    sig = torch.sqrt(torch.clamp(variance, min=0.0))[..., None]
    hist = torch.clamp(hist, -_maxpool3(-color) - sig, _maxpool3(color) + sig)
    ea, en = _guide_weight(albedo, normal, pa, pn, sigma_albedo, sigma_normal)
    ok = inb * reproject_valid[..., None].to(color.dtype)
    gate = ok * ea * en
    # noise-normalised luminance gate: reject where the warped history's
    # luminance differs from the current 3x3 mean by more than the
    # combined noise and a 5% relative tolerance explain
    lum_w = torch.tensor(_LUM, dtype=color.dtype, device=color.device)
    l3 = _box3(color @ lum_w)[..., None]
    dl2 = ((hist @ lum_w)[..., None] - l3) ** 2
    v_c3 = torch.clamp(variance, min=0.0)[..., None] / 9.0
    v_h = torch.clamp(pv, min=0.0)
    gate = gate * torch.exp(-dl2 / (v_c3 + v_h + (0.05 * l3) ** 2 + 1e-6))
    n_c = torch.clamp(count, min=1.0)[..., None]
    n_h = gate * torch.minimum(torch.clamp(pc, min=0.0), cap * n_c)
    n_t = n_c + n_h
    merged = (n_c * color + n_h * hist) / n_t
    v_c = torch.clamp(variance, min=0.0)[..., None]
    var_m = (n_c * n_c * v_c + n_h * n_h * v_h) / (n_t * n_t)
    return merged, var_m[..., 0], n_t[..., 0]

