"""Scene model: host SoA -> device tensors.

Port of henjou_tpu/scene/scenedata.py. The host side (`GeometryData`,
`InstanceData`, `make_material`, `SceneData`) is the JAX package's numpy
code, copied. The device side holds torch tensors:

- `DeviceScene`: static buffers uploaded once by `build_device_scene`,
  with per-triangle index maps (tri -> vertex ids / instance / material),
  the packed `tri_attr` and `mat_rows` tables, the light list and the
  texture atlas, plus the scene's static texture-usage facts.
- `FrameScene`: one frame's world-space triangles and normals, built by
  `build_frame_scene` with one gather and one affine transform.

Index fields that are u32 in the JAX package (tri_vidx, tri_instance,
tri_material, prim_offsets, light_prim_ids) are int64 here: torch indexes
with int64 and its uint32 supports few operators.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from plainref.math.affine import identity_affine
from plainref.math.vec import transform_normal, transform_position


# ---------------------------------------------------------------------------
# Host-side model (numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GeometryData:
    """Index range of one geometry in the global index buffer
    (reference: scene.h:9-12)."""

    index_offset: int
    index_count: int


@dataclasses.dataclass
class InstanceData:
    """One placed geometry (reference: scene.h:14-17)."""

    geometry_id: int
    animation_id: int = -1


def make_material(
    name: str = "default",
    base_color=(0.8, 0.8, 0.8),
    base_color_tex: int = -1,
    specular=(0.0, 0.0, 0.0),
    specular_tex: int = -1,
    roughness: float = 0.5,
    roughness_tex: int = -1,
    metallic: float = 0.0,
    metallic_tex: int = -1,
    sheen: float = 0.0,
    sheen_tex: int = -1,
    subsurface: float = 0.0,
    subsurface_tex: int = -1,
    clearcoat: float = 0.0,
    clearcoat_tex: int = -1,
    ior: float = 1.45,
    transmission: float = 0.0,
    normal_tex: int = -1,
    bump_tex: int = -1,
    emission=(0.0, 0.0, 0.0),
    emission_tex: int = -1,
    is_light: bool = False,
    ideal_specular: bool = False,
    is_thinfilm: bool = False,
) -> dict:
    """14-slot uber material (reference: include/renderer/material.h:10-63)."""
    return dict(
        name=name,
        base_color=np.asarray(base_color, np.float32),
        base_color_tex=base_color_tex,
        specular=np.asarray(specular, np.float32),
        specular_tex=specular_tex,
        roughness=float(roughness),
        roughness_tex=roughness_tex,
        metallic=float(metallic),
        metallic_tex=metallic_tex,
        sheen=float(sheen),
        sheen_tex=sheen_tex,
        subsurface=float(subsurface),
        subsurface_tex=subsurface_tex,
        clearcoat=float(clearcoat),
        clearcoat_tex=clearcoat_tex,
        ior=float(ior),
        transmission=float(transmission),
        normal_tex=normal_tex,
        bump_tex=bump_tex,
        emission=np.asarray(emission, np.float32),
        emission_tex=emission_tex,
        is_light=bool(is_light),
        ideal_specular=bool(ideal_specular),
        is_thinfilm=bool(is_thinfilm),
    )


@dataclasses.dataclass
class SceneData:
    """Host scene SoA (reference: scene.h:19-36)."""

    vertices: np.ndarray  # [V,3] f32 object space
    indices: np.ndarray  # [3T] u32 into vertices
    material_ids: np.ndarray  # [T] u32 per triangle of the GLOBAL soup
    normals: np.ndarray  # [V,3] f32
    texcoords: np.ndarray  # [V,2] f32
    colors: np.ndarray  # [V,3] f32 vertex colors

    materials: list  # list of make_material() dicts
    textures: list = dataclasses.field(default_factory=list)  # Texture objects
    animations: list = dataclasses.field(default_factory=list)
    geometries: list = dataclasses.field(default_factory=list)  # GeometryData
    instances: list = dataclasses.field(default_factory=list)  # InstanceData
    camera_animation_id: int = -1
    camera_fov_from_file: Optional[float] = None

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, np.float32).reshape(-1, 3)
        self.indices = np.asarray(self.indices, np.uint32).reshape(-1)
        self.material_ids = np.asarray(self.material_ids, np.uint32).reshape(-1)
        v = len(self.vertices)
        if self.normals is None or len(self.normals) == 0:
            self.normals = np.zeros((v, 3), np.float32)
        if self.texcoords is None or len(self.texcoords) == 0:
            self.texcoords = np.zeros((v, 2), np.float32)
        if self.colors is None or len(self.colors) == 0:
            self.colors = np.ones((v, 3), np.float32)
        self.normals = np.asarray(self.normals, np.float32).reshape(-1, 3)
        self.texcoords = np.asarray(self.texcoords, np.float32).reshape(-1, 2)
        self.colors = np.asarray(self.colors, np.float32).reshape(-1, 3)
        if not self.geometries:
            self.geometries = [GeometryData(0, len(self.indices))]
        if not self.instances:
            self.instances = [InstanceData(0)]


# ---------------------------------------------------------------------------
# Device-side tensors
# ---------------------------------------------------------------------------


class MaterialTable(NamedTuple):
    """Material SoA indexed by material id."""

    base_color: torch.Tensor  # [M,3]
    base_color_tex: torch.Tensor  # [M] i32, -1 = none
    roughness: torch.Tensor  # [M]
    roughness_tex: torch.Tensor
    metallic: torch.Tensor
    metallic_tex: torch.Tensor
    sheen: torch.Tensor
    subsurface: torch.Tensor
    clearcoat: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor
    normal_tex: torch.Tensor
    bump_tex: torch.Tensor
    emission: torch.Tensor  # [M,3]
    emission_tex: torch.Tensor
    is_light: torch.Tensor  # [M] bool
    ideal_specular: torch.Tensor  # [M] bool
    is_thinfilm: torch.Tensor  # [M] bool


# Packed-row layouts (column indices are the single source of truth).

# tri_attr [T, 24]: per-instanced-triangle interpolation attributes
TRI_TC0, TRI_TC1, TRI_TC2 = 0, 2, 4  # texcoords, 2 each
TRI_COL0, TRI_COL1, TRI_COL2 = 6, 9, 12  # vertex colors, 3 each
TRI_MAT = 15  # material id (exact float-encoded int)
TRI_INST = 16  # instance id
TRI_ROW_W = 24

# mat_rows [M, 48]: the SBT-record analogue, one row per material
MAT_BASE = 0  # base_color rgb
MAT_EMISSION = 3  # emission rgb
MAT_ROUGH = 6
MAT_METAL = 7
MAT_SUBSURF = 8
MAT_SHEEN = 9
MAT_CLEARCOAT = 10
MAT_IOR = 11
MAT_TRANSMISSION = 12
MAT_SPECFLAG = 13  # ideal_specular
MAT_LIGHTFLAG = 14  # is_light
MAT_FILMFLAG = 15  # is_thinfilm
# texture atlas rects (oy, ox, h, w); h == 0 means "no texture"
MAT_BASE_RECT = 16
MAT_ROUGH_RECT = 20
MAT_METAL_RECT = 24
MAT_NORMAL_RECT = 28
MAT_BUMP_RECT = 32
MAT_EMISSION_RECT = 36
MAT_ROW_W = 48


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """Static device buffers, uploaded once. `num_lights` and the has_*
    texture-usage facts are plain Python values: they select which code
    the surface fetch runs."""

    vertices: torch.Tensor  # [V,3] object space
    normals: torch.Tensor  # [V,3]
    texcoords: torch.Tensor  # [V,2]
    colors: torch.Tensor  # [V,3]
    tri_vidx: torch.Tensor  # [T,3] i64 global vertex ids per instanced tri
    tri_instance: torch.Tensor  # [T] i64 owning instance
    tri_material: torch.Tensor  # [T] i64
    tri_attr: torch.Tensor  # [T,TRI_ROW_W] packed interpolation row
    mat_rows: torch.Tensor  # [M,MAT_ROW_W] packed material row
    prim_offsets: torch.Tensor  # [I] i64 first global tri of each instance
    materials: MaterialTable
    light_prim_ids: torch.Tensor  # [L] i64 global tri ids (emissive)
    light_prim_emission: torch.Tensor  # [L,3]
    atlas: "TextureAtlas"  # packed scene textures
    num_lights: int
    has_base_tex: bool = False
    has_mr_tex: bool = False
    has_normal_tex: bool = False
    has_bump_tex: bool = False
    has_emission_tex: bool = False
    has_vert_colors: bool = False

    @property
    def device(self) -> torch.device:
        return self.vertices.device


class FrameScene(NamedTuple):
    """Per-frame world-space build: everything a trace needs."""

    tri_verts: torch.Tensor  # [T,3,3] world-space triangle vertices
    tri_normals: torch.Tensor  # [T,3,3] world-space per-vertex shading normals
    device: DeviceScene
    transforms: torch.Tensor  # [I,3,4]
    inv_transforms: torch.Tensor  # [I,3,4]


def build_device_scene(scene: SceneData, device) -> DeviceScene:
    """Upload the host SoA to `device` and precompute the per-instanced-
    triangle index maps (each instance gets its own global triangle range,
    `prim_offsets`)."""
    tri_vidx_list = []
    tri_inst_list = []
    tri_mat_list = []
    prim_offsets = []
    offset = 0
    for inst_id, inst in enumerate(scene.instances):
        geom = scene.geometries[inst.geometry_id]
        i0 = geom.index_offset
        cnt = geom.index_count
        idx = scene.indices[i0 : i0 + cnt].reshape(-1, 3)
        ntri = len(idx)
        tri_vidx_list.append(idx)
        tri_inst_list.append(np.full(ntri, inst_id, np.uint32))
        tri_mat_list.append(scene.material_ids[i0 // 3 : i0 // 3 + ntri])
        prim_offsets.append(offset)
        offset += ntri

    tri_vidx = np.concatenate(tri_vidx_list, axis=0).astype(np.uint32)
    tri_instance = np.concatenate(tri_inst_list)
    tri_material = np.concatenate(tri_mat_list).astype(np.uint32)

    # emissive triangles become the light list (any triangle whose
    # material has is_light set)
    mats = scene.materials
    is_light_mat = np.asarray([bool(m["is_light"]) for m in mats])
    light_ids = np.nonzero(is_light_mat[tri_material])[0]
    if len(light_ids):
        emission_tab = np.stack([m["emission"] for m in mats]).astype(np.float32)
        light_prim_ids = light_ids.astype(np.int64)
        light_prim_emission = emission_tab[tri_material[light_ids]]
    else:
        light_prim_ids = np.zeros((1,), np.int64)
        light_prim_emission = np.zeros((1, 3), np.float32)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def flag(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    table = MaterialTable(
        base_color=f32(np.stack([m["base_color"] for m in mats])),
        base_color_tex=i32([m["base_color_tex"] for m in mats]),
        roughness=f32([m["roughness"] for m in mats]),
        roughness_tex=i32([m["roughness_tex"] for m in mats]),
        metallic=f32([m["metallic"] for m in mats]),
        metallic_tex=i32([m["metallic_tex"] for m in mats]),
        sheen=f32([m["sheen"] for m in mats]),
        subsurface=f32([m["subsurface"] for m in mats]),
        clearcoat=f32([m["clearcoat"] for m in mats]),
        ior=f32([m["ior"] for m in mats]),
        transmission=f32([m["transmission"] for m in mats]),
        normal_tex=i32([m["normal_tex"] for m in mats]),
        bump_tex=i32([m["bump_tex"] for m in mats]),
        emission=f32(np.stack([m["emission"] for m in mats])),
        emission_tex=i32([m["emission_tex"] for m in mats]),
        is_light=flag([m["is_light"] for m in mats]),
        ideal_specular=flag([m["ideal_specular"] for m in mats]),
        is_thinfilm=flag([m["is_thinfilm"] for m in mats]),
    )

    from plainref.texture.atlas import build_atlas_np

    atlas_data, off_np, size_np = build_atlas_np(scene.textures)

    # ---- packed per-triangle interpolation rows (one gather per hit) ----
    t_count = len(tri_material)
    tri_attr = np.zeros((t_count, TRI_ROW_W), np.float32)
    tc = scene.texcoords[tri_vidx]  # [T,3,2]
    col = scene.colors[tri_vidx]  # [T,3,3]
    tri_attr[:, TRI_TC0 : TRI_TC0 + 2] = tc[:, 0]
    tri_attr[:, TRI_TC1 : TRI_TC1 + 2] = tc[:, 1]
    tri_attr[:, TRI_TC2 : TRI_TC2 + 2] = tc[:, 2]
    tri_attr[:, TRI_COL0 : TRI_COL0 + 3] = col[:, 0]
    tri_attr[:, TRI_COL1 : TRI_COL1 + 3] = col[:, 1]
    tri_attr[:, TRI_COL2 : TRI_COL2 + 3] = col[:, 2]
    tri_attr[:, TRI_MAT] = tri_material.astype(np.float32)
    tri_attr[:, TRI_INST] = tri_instance.astype(np.float32)

    # ---- packed material rows incl. texture atlas rects ----
    def _rect(tex_id: int) -> np.ndarray:
        if tex_id is None or tex_id < 0 or tex_id >= len(off_np):
            return np.zeros(4, np.float32)  # h == 0 -> no texture
        oy, ox = off_np[tex_id]
        h, w = size_np[tex_id]
        return np.asarray([oy, ox, h, w], np.float32)

    mat_rows = np.zeros((len(mats), MAT_ROW_W), np.float32)
    for i, m in enumerate(mats):
        r = mat_rows[i]
        r[MAT_BASE : MAT_BASE + 3] = m["base_color"]
        r[MAT_EMISSION : MAT_EMISSION + 3] = m["emission"]
        r[MAT_ROUGH] = m["roughness"]
        r[MAT_METAL] = m["metallic"]
        r[MAT_SUBSURF] = m["subsurface"]
        r[MAT_SHEEN] = m["sheen"]
        r[MAT_CLEARCOAT] = m["clearcoat"]
        r[MAT_IOR] = m["ior"]
        r[MAT_TRANSMISSION] = m["transmission"]
        r[MAT_SPECFLAG] = float(m["ideal_specular"])
        r[MAT_LIGHTFLAG] = float(m["is_light"])
        r[MAT_FILMFLAG] = float(m["is_thinfilm"])
        r[MAT_BASE_RECT : MAT_BASE_RECT + 4] = _rect(m["base_color_tex"])
        r[MAT_ROUGH_RECT : MAT_ROUGH_RECT + 4] = _rect(m["roughness_tex"])
        r[MAT_METAL_RECT : MAT_METAL_RECT + 4] = _rect(m["metallic_tex"])
        r[MAT_NORMAL_RECT : MAT_NORMAL_RECT + 4] = _rect(m["normal_tex"])
        r[MAT_BUMP_RECT : MAT_BUMP_RECT + 4] = _rect(m["bump_tex"])
        r[MAT_EMISSION_RECT : MAT_EMISSION_RECT + 4] = _rect(m["emission_tex"])

    from plainref.texture.atlas import TextureAtlas

    return DeviceScene(
        atlas=TextureAtlas(data=f32(atlas_data), offset=i32(off_np), size=i32(size_np)),
        tri_attr=f32(tri_attr),
        mat_rows=f32(mat_rows),
        has_base_tex=any(m["base_color_tex"] >= 0 for m in mats),
        has_mr_tex=any(
            m["roughness_tex"] >= 0 or m["metallic_tex"] >= 0 for m in mats
        ),
        has_normal_tex=any(m["normal_tex"] >= 0 for m in mats),
        has_bump_tex=any(m["bump_tex"] >= 0 for m in mats),
        has_emission_tex=any(m["emission_tex"] >= 0 for m in mats),
        has_vert_colors=bool(not np.all(scene.colors == 1.0)),
        vertices=f32(scene.vertices),
        normals=f32(scene.normals),
        texcoords=f32(scene.texcoords),
        colors=f32(scene.colors),
        tri_vidx=i64(tri_vidx),
        tri_instance=i64(tri_instance),
        tri_material=i64(tri_material),
        prim_offsets=i64(prim_offsets),
        materials=table,
        light_prim_ids=i64(light_prim_ids),
        light_prim_emission=f32(light_prim_emission),
        num_lights=len(light_ids),
    )


def identity_transforms(num_instances: int) -> np.ndarray:
    return np.broadcast_to(identity_affine(), (num_instances, 3, 4)).copy()


def build_frame_scene(
    device: DeviceScene,
    transforms: Optional[torch.Tensor] = None,
    inv_transforms: Optional[torch.Tensor] = None,
) -> FrameScene:
    """Flatten the instanced scene to world space for this frame: one
    batched gather and affine transform over all triangles."""
    num_inst = device.prim_offsets.shape[0]
    dev = device.device
    if transforms is None:
        transforms = torch.as_tensor(identity_transforms(num_inst), device=dev)
    if inv_transforms is None:
        inv_transforms = torch.as_tensor(identity_transforms(num_inst), device=dev)

    tri_xf = transforms[device.tri_instance]  # [T,3,4]
    tri_inv = inv_transforms[device.tri_instance]
    verts_obj = device.vertices[device.tri_vidx]  # [T,3,3]
    norms_obj = device.normals[device.tri_vidx]  # [T,3,3]
    tri_verts = transform_position(tri_xf[:, None], verts_obj)
    tri_normals = transform_normal(tri_inv[:, None], norms_obj)
    return FrameScene(
        tri_verts=tri_verts,
        tri_normals=tri_normals,
        device=device,
        transforms=transforms,
        inv_transforms=inv_transforms,
    )
