"""Surface-hit payload (port of henjou_tpu/integrator/payload.py).

`closest_hit` is the fused trace + surface fetch: intersect, gather the
triangle's packed attribute row, interpolate, and gather the material's
packed row, with texture lookups only for the map kinds the scene uses.
`SurfaceHit` holds the same 21 per-ray fields as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from henjou_torch.accel.bruteforce import intersect_bruteforce, occluded_bruteforce
from henjou_torch.math.constants import EPS_RAY, TMAX_RAY
from henjou_torch.math.vec import cross, normalize
from henjou_torch.scene import scenedata as sd
from henjou_torch.scene.scenedata import FrameScene
from henjou_torch.texture.atlas import sample_atlas_rect
from henjou_torch.utils.timer import span


@dataclasses.dataclass(frozen=True)
class Sky:
    """Environment light: an equirect HDR map or a constant colour, both
    scaled by `intensity` at miss time."""

    constant_color: torch.Tensor  # [3]
    intensity: torch.Tensor  # 0-d
    use_ibl: bool = False
    ibl_texture: Optional[torch.Tensor] = None  # [H,W,3] f32, equirect


class SurfaceHit(NamedTuple):
    is_hit: torch.Tensor  # [R] bool
    t: torch.Tensor  # [R]
    position: torch.Tensor  # [R,3] world
    normal: torch.Tensor  # [R,3] world shading normal
    vert_color: torch.Tensor  # [R,3]
    texcoord: torch.Tensor  # [R,2]
    material_id: torch.Tensor  # [R] i64
    basecolor: torch.Tensor  # [R,3]
    metallic: torch.Tensor  # [R]
    roughness: torch.Tensor  # [R]
    subsurface: torch.Tensor  # [R]
    sheen: torch.Tensor  # [R]
    clearcoat: torch.Tensor  # [R]
    ior: torch.Tensor  # [R]
    transmission: torch.Tensor  # [R]
    is_specular: torch.Tensor  # [R] bool
    emission: torch.Tensor  # [R,3]
    is_light: torch.Tensor  # [R] bool
    is_thinfilm: torch.Tensor  # [R] bool
    primitive_id: torch.Tensor  # [R] i64 (global instanced tri id)
    instance_id: torch.Tensor  # [R] i64


def eval_sky(sky: Sky, ray_d: torch.Tensor) -> torch.Tensor:
    """Miss emission: equirect IBL lookup or constant colour, times
    intensity."""
    if sky.use_ibl and sky.ibl_texture is not None:
        from henjou_torch.texture.ibl import sample_equirect

        col = sample_equirect(sky.ibl_texture, ray_d)
    else:
        col = sky.constant_color.expand(ray_d.shape)
    return col * sky.intensity


def closest_hit(
    frame: FrameScene,
    sky: Sky,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    tmin=EPS_RAY,
    tmax=TMAX_RAY,
    intersect_fn=None,
) -> SurfaceHit:
    """Trace + payload fill for a ray batch. `intersect_fn(tri_verts, o, d,
    tmin, tmax)` defaults to brute force."""
    with span("engine.trace"):
        dev = frame.device
        if intersect_fn is None:
            intersect_fn = intersect_bruteforce
        hit_t, prim, u, v, is_hit = intersect_fn(frame.tri_verts, ray_o, ray_d, tmin, tmax)

        prim = prim.to(torch.int64)
        prim_safe = torch.clamp(prim, min=0)
        w0 = (1.0 - u - v)[:, None]
        w1 = u[:, None]
        w2 = v[:, None]

        n_row = frame.tri_normals.reshape(-1, 9)[prim_safe]  # [R,9] world
        normal = normalize(n_row[:, 0:3] * w0 + n_row[:, 3:6] * w1 + n_row[:, 6:9] * w2)

        row = dev.tri_attr[prim_safe]  # [R,TRI_ROW_W]
        tc0 = row[:, sd.TRI_TC0 : sd.TRI_TC0 + 2]
        tc1 = row[:, sd.TRI_TC1 : sd.TRI_TC1 + 2]
        tc2 = row[:, sd.TRI_TC2 : sd.TRI_TC2 + 2]
        texcoord = tc0 * w0 + tc1 * w1 + tc2 * w2
        if dev.has_vert_colors:
            vert_color = (
                row[:, sd.TRI_COL0 : sd.TRI_COL0 + 3] * w0
                + row[:, sd.TRI_COL1 : sd.TRI_COL1 + 3] * w1
                + row[:, sd.TRI_COL2 : sd.TRI_COL2 + 3] * w2
            )
        else:
            vert_color = torch.ones_like(ray_o)
        mat_id = row[:, sd.TRI_MAT].to(torch.int64)
        inst_id = row[:, sd.TRI_INST].to(torch.int64)

        t_for_pos = torch.where(is_hit, hit_t, 0.0)
        position = ray_o + t_for_pos[:, None] * ray_d

        m = dev.mat_rows[mat_id]  # [R,MAT_ROW_W]

        # material textures: basecolor modulated by the base texture; glTF
        # metallicRoughness packs roughness in G and metallic in B
        tu, tv = texcoord[:, 0], texcoord[:, 1]
        atlas = dev.atlas.data
        basecolor = m[:, sd.MAT_BASE : sd.MAT_BASE + 3]
        if dev.has_base_tex:
            rect = m[:, sd.MAT_BASE_RECT : sd.MAT_BASE_RECT + 4]
            basecolor = basecolor * sample_atlas_rect(atlas, rect, tu, tv)[:, :3]
        roughness_v = m[:, sd.MAT_ROUGH]
        metallic_v = m[:, sd.MAT_METAL]
        if dev.has_mr_tex:
            rrect = m[:, sd.MAT_ROUGH_RECT : sd.MAT_ROUGH_RECT + 4]
            mr = sample_atlas_rect(atlas, rrect, tu, tv)
            roughness_v = roughness_v * torch.where(rrect[:, 2] > 0.0, mr[:, 1], 1.0)
            mrect = m[:, sd.MAT_METAL_RECT : sd.MAT_METAL_RECT + 4]
            mm = sample_atlas_rect(atlas, mrect, tu, tv)
            metallic_v = metallic_v * torch.where(mrect[:, 2] > 0.0, mm[:, 2], 1.0)

        # normal/bump mapping: tangent frame from the triangle's UVs
        if dev.has_normal_tex or dev.has_bump_tex:
            tri_v = frame.tri_verts[prim_safe]  # [R,3,3]
            e1 = tri_v[:, 1] - tri_v[:, 0]
            e2 = tri_v[:, 2] - tri_v[:, 0]
            duv1 = tc1 - tc0
            duv2 = tc2 - tc0
            det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
            inv_uv = torch.where(det_uv.abs() > 1e-12, 1.0 / det_uv, 0.0)[:, None]
            tangent = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv_uv
            tangent = tangent - normal * (tangent * normal).sum(-1, keepdim=True)
            t_len = torch.sqrt(torch.clamp((tangent * tangent).sum(-1), min=1e-20))
            has_frame = (t_len > 1e-8) & (det_uv.abs() > 1e-12)
            tangent = tangent / t_len[:, None]
            bitan = cross(normal, tangent)
            if dev.has_normal_tex:
                nrect = m[:, sd.MAT_NORMAL_RECT : sd.MAT_NORMAL_RECT + 4]
                nts = sample_atlas_rect(atlas, nrect, tu, tv)[:, :3] * 2.0 - 1.0
                n_mapped = normalize(
                    tangent * nts[:, 0:1] + bitan * nts[:, 1:2] + normal * nts[:, 2:3]
                )
                use = (nrect[:, 2] > 0.0) & has_frame
                normal = torch.where(use[:, None], n_mapped, normal)
            if dev.has_bump_tex:
                brect = m[:, sd.MAT_BUMP_RECT : sd.MAT_BUMP_RECT + 4]
                bw = torch.clamp(brect[:, 3], min=1.0)
                bh = torch.clamp(brect[:, 2], min=1.0)
                h0 = sample_atlas_rect(atlas, brect, tu, tv)[:, 0]
                hu = sample_atlas_rect(atlas, brect, tu + 1.0 / bw, tv)[:, 0]
                hv = sample_atlas_rect(atlas, brect, tu, tv + 1.0 / bh)[:, 0]
                n_bump = normalize(
                    normal + tangent * (h0 - hu)[:, None] + bitan * (h0 - hv)[:, None]
                )
                use = (brect[:, 2] > 0.0) & has_frame
                normal = torch.where(use[:, None], n_bump, normal)

        emission_mat = m[:, sd.MAT_EMISSION : sd.MAT_EMISSION + 3]
        if dev.has_emission_tex:
            erect = m[:, sd.MAT_EMISSION_RECT : sd.MAT_EMISSION_RECT + 4]
            emission_mat = emission_mat * sample_atlas_rect(atlas, erect, tu, tv)[:, :3]
        hitf = is_hit[:, None]
        emission = torch.where(hitf, emission_mat, eval_sky(sky, ray_d))

        zero3 = torch.zeros_like(basecolor)
        return SurfaceHit(
            is_hit=is_hit,
            t=hit_t,
            position=torch.where(hitf, position, zero3),
            normal=torch.where(hitf, normal, zero3),
            vert_color=torch.where(hitf, vert_color, zero3),
            texcoord=torch.where(hitf, texcoord, torch.zeros_like(texcoord)),
            material_id=torch.where(is_hit, mat_id, 0),
            basecolor=torch.where(hitf, basecolor, zero3),
            metallic=torch.where(is_hit, metallic_v, 0.0),
            roughness=torch.where(is_hit, roughness_v, 0.0),
            subsurface=torch.where(is_hit, m[:, sd.MAT_SUBSURF], 0.0),
            sheen=torch.where(is_hit, m[:, sd.MAT_SHEEN], 0.0),
            clearcoat=torch.where(is_hit, m[:, sd.MAT_CLEARCOAT], 0.0),
            ior=torch.where(is_hit, m[:, sd.MAT_IOR], 1.0),
            transmission=torch.where(is_hit, m[:, sd.MAT_TRANSMISSION], 1.0),
            is_specular=is_hit & (m[:, sd.MAT_SPECFLAG] > 0.0),
            emission=emission,
            is_light=is_hit & (m[:, sd.MAT_LIGHTFLAG] > 0.0),
            is_thinfilm=is_hit & (m[:, sd.MAT_FILMFLAG] > 0.0),
            primitive_id=torch.where(is_hit, prim, 0),
            instance_id=torch.where(is_hit, inst_id, 0),
        )


def occluded(frame: FrameScene, ray_o, ray_d, tmin, tmax, occluded_fn=None):
    """Shadow-ray visibility."""
    if occluded_fn is None:
        occluded_fn = occluded_bruteforce
    with span("engine.trace"):
        return occluded_fn(frame.tri_verts, ray_o, ray_d, tmin, tmax)
