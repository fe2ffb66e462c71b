"""Thin-film interference LUT (port of henjou_tpu/texture/lut.py).

A [H,W,3] f32 table indexed by (film thickness, cos theta), sampled
bilinearly with wrap addressing; it replaces the Disney specular F0 on
thin-film materials.
"""

from __future__ import annotations

import numpy as np
import torch

from plainref.texture.sampler import sample_bilinear_wrap


def load_lut_png(path: str, device) -> torch.Tensor:
    """Load the LUT PNG as NonColor (no sRGB decode)."""
    from plainref.post.png import read_png

    img = read_png(path)
    rgb = img[..., :3].astype(np.float32) / 255.0
    return torch.as_tensor(rgb, device=device)


def default_lut_np() -> np.ndarray:
    """Analytic Airy-reflectance LUT used when no LUT file is configured:
    a thin film of ior 1.5 on ior 1.0, thickness 0..1000 nm over u, cos
    theta over v, RGB at 612/549/465 nm."""
    n_film = 1.5
    thick = np.linspace(0.0, 1000.0, 256)[None, :, None]  # nm, u axis
    cos_t = np.linspace(1e-3, 1.0, 256)[:, None, None]  # v axis
    wavelengths = np.asarray([612.0, 549.0, 465.0])[None, None, :]

    sin2 = (1.0 - cos_t**2) / (n_film**2)
    cos_f = np.sqrt(np.maximum(1.0 - sin2, 0.0))
    r01 = ((1.0 - n_film) / (1.0 + n_film)) ** 2
    r01 = r01 + (1.0 - r01) * (1.0 - cos_t) ** 5
    phase = 4.0 * np.pi * n_film * thick * cos_f / wavelengths
    refl = 2.0 * r01 * (1.0 + np.cos(phase)) / (1.0 + r01**2 * (1 + np.cos(phase)))
    return np.clip(refl, 0.0, 1.0).astype(np.float32)


def default_lut(device) -> torch.Tensor:
    return torch.as_tensor(default_lut_np(), device=device)


def sample_lut(lut: torch.Tensor, thickness, cosine) -> torch.Tensor:
    """u = thickness, v = cos theta."""
    return sample_bilinear_wrap(lut, thickness, cosine)
