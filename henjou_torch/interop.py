"""Convert the JAX package's state, given as numpy arrays, into the port's
tensors.

Each function takes an object with the JAX structure's field names (for
example a `henjou_tpu` DeviceScene, or any object whose fields
`numpy.asarray` accepts) and a torch device, and returns the port's
counterpart. This module imports neither JAX nor `henjou_tpu`: the arrays
are read through `numpy.asarray`. Floating-point fields become float32
tensors (a float64 numpy array would otherwise become a float64 tensor),
u32/i32 index fields become int64, and flags bool, following the port's
dtype conventions (scene/scenedata.py); the cluster packs keep their i32
`order`, which the kernels read.
"""

from __future__ import annotations

import numpy as np
import torch

from henjou_torch.accel.pallas_binned import BinnedClusters
from henjou_torch.accel.pallas_cluster import PackedClusters
from henjou_torch.accel.pallas_cluster_hbm import HbmClusters
from henjou_torch.accel.pallas_mxu import MxuClusters
from henjou_torch.runtime.camera import Camera
from henjou_torch.scene.scenedata import DeviceScene, FrameScene, MaterialTable
from henjou_torch.texture.atlas import TextureAtlas


def _f32(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=device)


def _i64(x, device):
    return torch.as_tensor(np.array(x).astype(np.int64), device=device)


def _i32(x, device):
    return torch.as_tensor(np.array(x).astype(np.int32), device=device)


def _bool(x, device):
    return torch.as_tensor(np.array(x, bool), device=device)


_MATERIAL_KINDS = {
    "base_color_tex": _i32, "roughness_tex": _i32, "metallic_tex": _i32,
    "normal_tex": _i32, "bump_tex": _i32, "emission_tex": _i32,
    "is_light": _bool, "ideal_specular": _bool, "is_thinfilm": _bool,
}
_INDEX_FIELDS = ("tri_vidx", "tri_instance", "tri_material", "prim_offsets",
                 "light_prim_ids")
_FLAG_FIELDS = ("has_base_tex", "has_mr_tex", "has_normal_tex", "has_bump_tex",
                "has_emission_tex", "has_vert_colors")


def device_scene_from_numpy(src, device) -> DeviceScene:
    """A JAX `DeviceScene` (or its numpy twin) -> the port's DeviceScene."""
    mats = MaterialTable(**{
        name: _MATERIAL_KINDS.get(name, _f32)(getattr(src.materials, name), device)
        for name in MaterialTable._fields
    })
    atlas = TextureAtlas(
        data=_f32(src.atlas.data, device),
        offset=_i32(src.atlas.offset, device),
        size=_i32(src.atlas.size, device),
    )
    fields = {}
    for f in ("vertices", "normals", "texcoords", "colors", "tri_attr", "mat_rows",
              "light_prim_emission"):
        fields[f] = _f32(getattr(src, f), device)
    for f in _INDEX_FIELDS:
        fields[f] = _i64(getattr(src, f), device)
    for f in _FLAG_FIELDS:
        fields[f] = bool(getattr(src, f))
    return DeviceScene(materials=mats, atlas=atlas,
                       num_lights=int(src.num_lights), **fields)


def frame_scene_from_numpy(src, device) -> FrameScene:
    """A JAX `FrameScene` (or its numpy twin) -> the port's FrameScene."""
    return FrameScene(
        tri_verts=_f32(src.tri_verts, device),
        tri_normals=_f32(src.tri_normals, device),
        device=device_scene_from_numpy(src.device, device),
        transforms=_f32(src.transforms, device),
        inv_transforms=_f32(src.inv_transforms, device),
    )


def binned_from_numpy(src, device) -> BinnedClusters:
    """A JAX `BinnedClusters` (or its numpy twin) -> the port's."""
    return BinnedClusters(
        rows=_f32(src.rows, device),
        aabb=_f32(src.aabb, device),
        gaabb=_f32(src.gaabb, device),
        scene_lo=_f32(src.scene_lo, device),
        scene_hi=_f32(src.scene_hi, device),
        num_clusters=int(src.num_clusters),
        group=int(src.group),
        num_groups=int(src.num_groups),
        k=int(src.k),
    )


def packed_from_numpy(src, device) -> PackedClusters:
    """A JAX `PackedClusters` (or its numpy twin) -> the port's."""
    planes = {f: _f32(getattr(src, f), device) for f in
              ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")}
    return PackedClusters(**planes, order=_i32(src.order, device),
                          aabb=_f32(src.aabb, device), num_clusters=int(src.num_clusters))


def hbm_from_numpy(src, device) -> HbmClusters:
    """A JAX `HbmClusters` (or its numpy twin) -> the port's."""
    return HbmClusters(
        rows=_f32(src.rows, device), order=_i32(src.order, device),
        aabb=_f32(src.aabb, device), aabb2=_f32(src.aabb2, device),
        num_clusters=int(src.num_clusters), num_super=int(src.num_super),
    )


def mxu_from_numpy(src, device) -> MxuClusters:
    """A JAX `MxuClusters` (or its numpy twin) -> the port's."""
    return MxuClusters(
        g_rows=_f32(src.g_rows, device), order=_i32(src.order, device),
        aabb=_f32(src.aabb, device), aabb2=_f32(src.aabb2, device),
        centers=_f32(src.centers, device),
        num_clusters=int(src.num_clusters), num_super=int(src.num_super),
    )


def camera_from_numpy(src, device) -> Camera:
    """A JAX `Camera` -> the port's Camera."""
    return Camera(*(_f32(getattr(src, f), device) for f in Camera._fields))
