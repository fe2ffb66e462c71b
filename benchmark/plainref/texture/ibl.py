"""Equirectangular IBL environment sampling (port of
henjou_tpu/texture/ibl.py). Convention: v = acos(y)/pi (zenith up),
u = atan2(z, x) wrapped."""

from __future__ import annotations

import numpy as np
import torch

from plainref.texture.sampler import sample_bilinear_wrap


def sample_equirect(tex: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """tex [H,W,3|4] f32, d [...,3] unit directions -> [...,3]."""
    phi = torch.atan2(d[..., 2], d[..., 0])
    u = phi / (2.0 * np.pi) + 0.5
    v = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / np.pi
    return sample_bilinear_wrap(tex, u, v)[..., :3]


def load_ibl(path: str, device) -> torch.Tensor:
    from plainref.texture.hdr import read_hdr

    return torch.as_tensor(read_hdr(path), device=device)
