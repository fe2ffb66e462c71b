"""Texture assets: load, decode, dedupe.

Port of henjou_tpu/texture/texture.py: host numpy code, copied.

Rebuild of the reference Texture/HDRTexture (include/renderer/texture.h)
and the name->id dedupe cache (include/loader/texture_load.h:7-19).
Textures are decoded to f32 RGBA on host; sRGB decode happens here at
load time (the reference defers it to the CUDA TMU's sRGB mode,
renderer.h:785-789 — same math, different place).
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import os

import numpy as np

log = logging.getLogger("plainref")


class TexType(enum.Enum):
    # reference: texture.h:10-14
    SRGB = "sRGB"
    NON_COLOR = "NonColor"
    HDR = "HDR"


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


@dataclasses.dataclass
class Texture:
    """Decoded image: [H,W,4] f32 (linearized when tex_type == SRGB)."""

    name: str
    data: np.ndarray
    tex_type: TexType

    @property
    def height(self):
        return self.data.shape[0]

    @property
    def width(self):
        return self.data.shape[1]


def texture_from_image(
    img: np.ndarray, name: str, tex_type: TexType
) -> Texture:
    """Normalize a decoded [H,W,C] image (uint8 or f32 in [0,1]) into an
    RGBA f32 Texture, applying sRGB linearization when requested."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    if img.shape[2] == 2:  # gray+alpha
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=2), img[..., 1:]], -1)
    if img.shape[2] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    if tex_type == TexType.SRGB:
        img = np.concatenate(
            [srgb_to_linear(img[..., :3]), img[..., 3:]], axis=-1
        )
    return Texture(name, img.astype(np.float32), tex_type)


def load_texture_bytes(
    data: bytes, name: str, tex_type: TexType, mime_type: str = ""
) -> Texture:
    """Decode an in-memory image (GLB bufferView / data URI). PNG only —
    the image ships no JPEG codec (raises ValueError for other formats;
    callers downgrade to no-texture with a warning, matching the
    reference's stb_image failure path)."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        from plainref.post.png import decode_png

        return texture_from_image(decode_png(data, name=name), name, tex_type)
    raise ValueError(
        f"unsupported embedded image format ({mime_type or 'unknown'}): {name}"
    )


def load_texture_file(path: str, tex_type: TexType) -> Texture:
    """8-bit images via the PNG codec (stb_image analogue, texture.h:23-38);
    .hdr via the Radiance loader (texture.h:42-169)."""
    lower = path.lower()
    if lower.endswith(".hdr"):
        from plainref.texture.hdr import read_hdr

        rgb = read_hdr(path)
        rgba = np.concatenate([rgb, np.ones_like(rgb[..., :1])], axis=-1)
        return Texture(os.path.basename(path), rgba.astype(np.float32), TexType.HDR)
    if lower.endswith(".png"):
        from plainref.post.png import read_png

        img = read_png(path)
    elif lower.endswith((".ppm", ".pnm")):
        img = _read_ppm(path)
    else:
        raise ValueError(f"unsupported texture format: {path}")
    return texture_from_image(img, os.path.basename(path), tex_type)


def _read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    parts = data.split(maxsplit=4)
    magic, w, h, maxv = parts[0], int(parts[1]), int(parts[2]), int(parts[3])
    if magic != b"P6":
        raise ValueError("only binary PPM (P6) supported")
    pix = np.frombuffer(parts[4], np.uint8, count=w * h * 3).reshape(h, w, 3)
    return pix.astype(np.float32) / float(maxv)


def load_texture_cached(
    textures: list, cache: dict, name: str, directory: str, tex_type: TexType
) -> int:
    """Name->id dedupe (reference loadTexture, texture_load.h:7-19).
    Returns the texture id, or -1 if the file is missing/undecodable."""
    if name in cache:
        return cache[name]
    path = os.path.join(directory, name)
    try:
        tex = load_texture_file(path, tex_type)
    except (OSError, ValueError, NotImplementedError) as e:
        log.warning("texture load failed (%s): %s", name, e)
        cache[name] = -1
        return -1
    textures.append(tex)
    tex_id = len(textures) - 1
    cache[name] = tex_id
    return tex_id
