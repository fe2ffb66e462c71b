"""Texture atlas: all scene textures in one device tensor.

Port of henjou_tpu/texture/atlas.py. Heterogeneous images are shelf-packed
into a single [H,W,4] f32 array; the sampler wraps UVs inside each
sub-rectangle and does the bilinear footprint by hand (wrap + bilinear;
sRGB decode already happened at load time).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    data: torch.Tensor  # [AH,AW,4] f32
    offset: torch.Tensor  # [N,2] i32 (y, x)
    size: torch.Tensor  # [N,2] i32 (h, w)


def build_atlas_np(textures: List):
    """Shelf-pack Texture objects (texture.Texture) on the host: the JAX
    package's `build_atlas` before the upload, which
    `scene.scenedata.build_device_scene` does. Returns
    numpy (data [AH,AW,4] f32, offset [N,2] i32, size [N,2] i32); always at
    least a 1x1 white atlas."""
    if not textures:
        return (
            np.ones((1, 1, 4), np.float32),
            np.zeros((1, 2), np.int32),
            np.ones((1, 2), np.int32),
        )

    order = sorted(range(len(textures)), key=lambda i: -textures[i].height)
    atlas_w = max(max(t.width for t in textures), 64)
    pos = [None] * len(textures)
    shelf_y, shelf_h, cur_x = 0, 0, 0
    for i in order:
        t = textures[i]
        if cur_x + t.width > atlas_w:
            shelf_y += shelf_h
            shelf_h, cur_x = 0, 0
        pos[i] = (shelf_y, cur_x)
        cur_x += t.width
        shelf_h = max(shelf_h, t.height)
    atlas_h = shelf_y + shelf_h

    data = np.zeros((atlas_h, atlas_w, 4), np.float32)
    offset = np.zeros((len(textures), 2), np.int32)
    size = np.zeros((len(textures), 2), np.int32)
    for i, t in enumerate(textures):
        y, x = pos[i]
        data[y : y + t.height, x : x + t.width] = t.data[..., :4]
        offset[i] = (y, x)
        size[i] = (t.height, t.width)
    return data, offset, size


def build_atlas(textures: List, device) -> TextureAtlas:
    """`build_atlas_np`'s shelf pack as a TextureAtlas of tensors on
    `device`; a 1x1 white atlas when there are no textures."""
    data, offset, size = build_atlas_np(textures)
    dev = torch.device(device)
    return TextureAtlas(data=torch.from_numpy(data).to(dev),
                        offset=torch.from_numpy(offset).to(dev),
                        size=torch.from_numpy(size).to(dev))


def sample_atlas_rect(data: torch.Tensor, rect: torch.Tensor, u, v) -> torch.Tensor:
    """Bilinear wrap sample with the atlas rect (oy, ox, h, w) carried per
    lane in `rect` [R,4]; h == 0 means "no texture" (returns white).
    Returns [R,4]."""
    oy = rect[:, 0].to(torch.int64)
    ox = rect[:, 1].to(torch.int64)
    hi = torch.clamp(rect[:, 2].to(torch.int64), min=1)
    wi = torch.clamp(rect[:, 3].to(torch.int64), min=1)
    h = hi.to(torch.float32)
    w = wi.to(torch.float32)

    # wrap addressing, texel centers at (i+0.5)/W
    x = (u - torch.floor(u)) * w - 0.5
    y = (v - torch.floor(v)) * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    x0i = torch.remainder(x0.to(torch.int64), wi)
    y0i = torch.remainder(y0.to(torch.int64), hi)
    x1i = torch.remainder(x0i + 1, wi)
    y1i = torch.remainder(y0i + 1, hi)

    t00 = data[oy + y0i, ox + x0i]
    t10 = data[oy + y0i, ox + x1i]
    t01 = data[oy + y1i, ox + x0i]
    t11 = data[oy + y1i, ox + x1i]
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    out = top * (1.0 - fy) + bot * fy
    return torch.where((rect[:, 2] > 0.0)[:, None], out, torch.ones_like(out))

