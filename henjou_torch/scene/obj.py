"""Wavefront OBJ/MTL loader -> SceneData (port of henjou_tpu/scene/obj.py:
host code, copied).

Behavior-parity rebuild of the reference's tinyobjloader path
(include/loader/objloader.h:12-171): de-indexed triangle soup, one
geometry + one instance per shape (o/g group), per-face material ids,
face-normal fallback when the file has no normals (objloader.h:142-149),
and the same MTL -> uber-material mapping including the PBR extension
tags (Pm metallic, Pr roughness, Ps sheen, Pc clearcoat -> clearcoat,
Pcr clearcoat roughness -> subsurface, objloader.h:62-69), Ni -> ior,
Ks -> specular, Ke -> emission with is_light when any component > 0.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from henjou_torch.scene.scenedata import (
    GeometryData,
    InstanceData,
    SceneData,
    make_material,
)

log = logging.getLogger("henjou_torch")


def _parse_mtl(path: str) -> dict:
    """MTL file -> {name: material dict}. Unknown keys ignored."""
    mats = {}
    cur = None
    try:
        f = open(path, errors="replace")
    except OSError:
        log.warning("MTL not found: %s", path)
        return mats
    with f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = dict(
                    name=parts[1] if len(parts) > 1 else "",
                    diffuse=(1.0, 1.0, 1.0),
                    specular=(0.0, 0.0, 0.0),
                    emission=(0.0, 0.0, 0.0),
                    metallic=0.0,
                    roughness=0.5,
                    sheen=0.0,
                    clearcoat_thickness=0.0,
                    clearcoat_roughness=0.0,
                    ior=1.0,
                )
                mats[cur["name"]] = cur
            elif cur is None:
                continue
            elif key == "Kd":
                cur["diffuse"] = tuple(float(x) for x in parts[1:4])
            elif key == "Ks":
                cur["specular"] = tuple(float(x) for x in parts[1:4])
            elif key == "Ke":
                cur["emission"] = tuple(float(x) for x in parts[1:4])
            elif key == "Ni":
                cur["ior"] = float(parts[1])
            elif key == "Pm":
                cur["metallic"] = float(parts[1])
            elif key == "Pr":
                cur["roughness"] = float(parts[1])
            elif key == "Ps":
                cur["sheen"] = float(parts[1])
            elif key == "Pc":
                cur["clearcoat_thickness"] = float(parts[1])
            elif key == "Pcr":
                cur["clearcoat_roughness"] = float(parts[1])
    return mats


def _mtl_to_material(m: dict):
    """objloader.h:45-85 mapping."""
    emission = np.asarray(m["emission"], np.float32)
    return make_material(
        name=m["name"],
        base_color=m["diffuse"],
        specular=m["specular"],
        metallic=m["metallic"],
        roughness=m["roughness"],
        sheen=m["sheen"],
        subsurface=m["clearcoat_roughness"],  # objloader.h:64-66
        clearcoat=m["clearcoat_thickness"],  # objloader.h:68-69
        ior=m["ior"],
        emission=emission,
        is_light=bool((emission > 0).any()),
    )


def load_obj(path: str) -> SceneData:
    directory = os.path.dirname(os.path.abspath(path))

    positions, normals_in, texcoords_in = [], [], []
    vcolors: list = []
    has_vcolor = False
    mtl_order: list = []
    mtl_index: dict = {}
    materials_by_name: dict = {}

    # per-shape face lists; a shape = o/g group (tinyobj behavior)
    shapes = []  # list of (faces, face_mats); face = [(vi, ti, ni) x 3]
    cur_faces, cur_mats = [], []
    cur_mat = -1

    def end_shape():
        nonlocal cur_faces, cur_mats
        if cur_faces:
            shapes.append((cur_faces, cur_mats))
        cur_faces, cur_mats = [], []

    def resolve(idx: str, count: int):
        i = int(idx)
        return i - 1 if i > 0 else count + i

    with open(path, errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                positions.append([float(x) for x in parts[1:4]])
                # vertex-color extension `v x y z r g b` (tinyobj reads
                # these into attrib.colors; ref scene.h:25 uploads them)
                if len(parts) >= 7:
                    vcolors.append([float(x) for x in parts[4:7]])
                    has_vcolor = True
                else:
                    vcolors.append([1.0, 1.0, 1.0])
            elif key == "vn":
                normals_in.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                texcoords_in.append([float(x) for x in parts[1:3]])
            elif key == "f":
                corners = []
                for vert in parts[1:]:
                    comps = vert.split("/")
                    vi = resolve(comps[0], len(positions))
                    ti = (
                        resolve(comps[1], len(texcoords_in))
                        if len(comps) > 1 and comps[1]
                        else -1
                    )
                    ni = (
                        resolve(comps[2], len(normals_in))
                        if len(comps) > 2 and comps[2]
                        else -1
                    )
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    cur_faces.append((corners[0], corners[k], corners[k + 1]))
                    cur_mats.append(cur_mat)
            elif key == "usemtl":
                name = parts[1] if len(parts) > 1 else ""
                if name not in mtl_index:
                    mtl_index[name] = len(mtl_order)
                    mtl_order.append(name)
                cur_mat = mtl_index[name]
            elif key == "mtllib":
                mtl_path = os.path.join(directory, " ".join(parts[1:]))
                materials_by_name.update(_parse_mtl(mtl_path))
            elif key in ("o", "g"):
                end_shape()
    end_shape()
    if not shapes:
        raise ValueError(f"OBJ has no faces: {path}")

    has_material = bool(mtl_order)
    if has_material:
        materials = []
        for name in mtl_order:
            if name in materials_by_name:
                materials.append(_mtl_to_material(materials_by_name[name]))
            else:
                materials.append(make_material(name))
    else:
        materials = [make_material("default", base_color=(1.0, 1.0, 1.0))]

    positions = np.asarray(positions, np.float32)
    normals_in = np.asarray(normals_in, np.float32) if normals_in else None
    texcoords_in = np.asarray(texcoords_in, np.float32) if texcoords_in else None

    vcolors_np = np.asarray(vcolors, np.float32) if has_vcolor else None

    verts, norms, texcs, mat_ids = [], [], [], []
    cols: list = []
    geometries, instances = [], []
    index_offset = 0
    for faces, face_mats in shapes:
        count = 0
        for face, mid in zip(faces, face_mats):
            vs = [positions[vi] for vi, _, _ in face]
            verts.extend(vs)
            if vcolors_np is not None:
                cols.extend(vcolors_np[vi] for vi, _, _ in face)
            if normals_in is not None and all(ni >= 0 for _, _, ni in face):
                norms.extend(normals_in[ni] for _, _, ni in face)
            else:
                # face-normal fallback with the reference's construction
                # (objloader.h:142-149: normalized edge vectors first)
                e1 = vs[1] - vs[0]
                e2 = vs[2] - vs[0]
                e1 = e1 / max(np.linalg.norm(e1), 1e-20)
                e2 = e2 / max(np.linalg.norm(e2), 1e-20)
                n = np.cross(e1, e2)
                n = n / max(np.linalg.norm(n), 1e-20)
                norms.extend([n, n, n])
            texcs.extend(
                texcoords_in[ti] if (texcoords_in is not None and ti >= 0) else (0.0, 0.0)
                for _, ti, _ in face
            )
            mat_ids.append(max(mid, 0) if has_material else 0)
            count += 3
        geometries.append(GeometryData(index_offset, count))
        instances.append(InstanceData(geometry_id=len(geometries) - 1))
        index_offset += count

    scene = SceneData(
        vertices=np.asarray(verts, np.float32),
        indices=np.arange(len(verts), dtype=np.uint32),
        material_ids=np.asarray(mat_ids, np.uint32),
        normals=np.asarray(norms, np.float32),
        texcoords=np.asarray(texcs, np.float32),
        colors=(np.asarray(cols, np.float32) if vcolors_np is not None else None),
        materials=materials,
        geometries=geometries,
        instances=instances,
    )
    log.info(
        "OBJ loaded: %d tris, %d shapes, %d materials",
        len(mat_ids),
        len(shapes),
        len(materials),
    )
    return scene
