"""Gather-based bilinear texture sampling (port of
henjou_tpu/texture/sampler.py): normalized coords, wrap addressing,
bilinear filter, texel centers at (i+0.5)/W."""

from __future__ import annotations

import torch


def sample_bilinear_wrap(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """tex: [H,W,C] f32. u,v: [...] normalized coords (wrap). Returns [...,C]."""
    h, w = tex.shape[0], tex.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    x1 = torch.remainder(x0 + 1, w)
    y1 = torch.remainder(y0 + 1, h)
    x0 = torch.remainder(x0, w)
    y0 = torch.remainder(y0, h)
    t00 = tex[y0, x0]
    t10 = tex[y0, x1]
    t01 = tex[y1, x0]
    t11 = tex[y1, x1]
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy
