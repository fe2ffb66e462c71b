"""Port parity: SceneData, DeviceScene, FrameScene, the cluster pack and the
numpy interop, on the gallery and contest glTF scenes (tolerance: none,
every field equal)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from henjou_torch.accel import pallas_binned as tpb
from henjou_torch.scene import gltf as tgltf
from henjou_torch.scene import scenedata as tsd
from henjou_tpu.accel import pallas_binned as jpb
from henjou_tpu.scene import gltf as jgltf
from henjou_tpu.scene import scenedata as jsd

from tests import torch_interop as interop

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

SCENES = ["scenes/sphere_gallery.gltf", "scenes/rtcamp.gltf"]


@functools.lru_cache(maxsize=None)
def _loaded(path):
    """(jax SceneData, port SceneData, frame-0 transforms, inverses)."""
    from henjou_tpu.math.affine import invert_affine

    js = jgltf.load_gltf(path)
    ts = tgltf.load_gltf(path)
    xf = jsd.identity_transforms(len(js.instances))
    for i, inst in enumerate(js.instances):
        if 0 <= inst.animation_id < len(js.animations):
            xf[i] = js.animations[inst.animation_id].get_affine(0.0)
    inv = np.stack([invert_affine(m) for m in xf])
    return js, ts, xf, inv


@functools.lru_cache(maxsize=None)
def _frames(path):
    js, ts, xf, inv = _loaded(path)
    jf = jsd.build_frame_scene(jsd.build_device_scene(js), xf, inv)
    tf = tsd.build_frame_scene(
        tsd.build_device_scene(ts, "cpu"), torch.from_numpy(xf), torch.from_numpy(inv)
    )
    return jf, tf


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.astype(np.float32), b, err_msg=what)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=what)


@pytest.mark.parametrize("path", SCENES)
def test_scenedata_equal(path):
    js, ts, _, _ = _loaded(path)
    for f in ("vertices", "indices", "material_ids", "normals", "texcoords", "colors"):
        _eq(getattr(js, f), getattr(ts, f), f)
    assert len(js.materials) == len(ts.materials)
    for mj, mt in zip(js.materials, ts.materials):
        assert mj.keys() == mt.keys()
        for k in mj:
            assert np.array_equal(np.asarray(mj[k]), np.asarray(mt[k])), k
    assert [t.data.tobytes() for t in js.textures] == [t.data.tobytes() for t in ts.textures]
    assert [dataclasses.astuple(g) for g in js.geometries] == [dataclasses.astuple(g) for g in ts.geometries]
    assert [dataclasses.astuple(i) for i in js.instances] == [dataclasses.astuple(i) for i in ts.instances]
    assert (js.camera_animation_id, js.camera_fov_from_file) == (ts.camera_animation_id, ts.camera_fov_from_file)
    for aj, at in zip(js.animations, ts.animations):
        for tr in ("translation", "rotation", "scale"):
            a, b = getattr(aj, tr), getattr(at, tr)
            assert (a.keys, a.values, a.interpolation) == (b.keys, b.values, b.interpolation)


def _assert_device_scene_equal(jd, td):
    for f in ("vertices", "normals", "texcoords", "colors", "tri_vidx", "tri_instance",
              "tri_material", "tri_attr", "mat_rows", "prim_offsets", "light_prim_ids",
              "light_prim_emission"):
        _eq(getattr(jd, f), getattr(td, f), f)
    for f in jd.materials._fields:
        _eq(getattr(jd.materials, f), getattr(td.materials, f), f)
    for f in ("data", "offset", "size"):
        _eq(getattr(jd.atlas, f), getattr(td.atlas, f), f)
    for f in ("num_lights", "has_base_tex", "has_mr_tex", "has_normal_tex", "has_bump_tex",
              "has_emission_tex", "has_vert_colors"):
        assert getattr(jd, f) == getattr(td, f), f


@pytest.mark.parametrize("path", SCENES)
def test_device_and_frame_scene_equal(path):
    jf, tf = _frames(path)
    _assert_device_scene_equal(jf.device, tf.device)
    for f in ("tri_verts", "tri_normals", "transforms", "inv_transforms"):
        _eq(getattr(jf, f), getattr(tf, f), f)


@pytest.mark.parametrize("path", SCENES)
def test_pack_binned_equal(path):
    jf, tf = _frames(path)
    jb = jpb.pack_binned_np(np.asarray(jf.tri_verts))
    tb = tpb.pack_binned_np(tf.tri_verts.numpy(), "cpu")
    for f in ("rows", "aabb", "gaabb", "scene_lo", "scene_hi"):
        _eq(getattr(jb, f), getattr(tb, f), f)
    assert (jb.num_clusters, jb.group, jb.num_groups, jb.k) == (
        tb.num_clusters, tb.group, tb.num_groups, tb.k)
    # the same state moved across by the interop module
    ib = interop.binned_from_numpy(jb, "cpu")
    for f in ("rows", "aabb", "gaabb", "scene_lo", "scene_hi"):
        # bitwise: plane 12 holds triangle ids bitcast to f32 (-1 is a NaN)
        assert torch.equal(getattr(ib, f).view(torch.int32), getattr(tb, f).view(torch.int32)), f
    assert (ib.num_clusters, ib.group, ib.num_groups) == (tb.num_clusters, tb.group, tb.num_groups)


@pytest.mark.parametrize("path", SCENES)
def test_interop_frame_scene(path):
    """frame_scene_from_numpy on the JAX FrameScene equals the port's own
    build, dtypes included (f32 floats, i64 indices)."""
    jf, tf = _frames(path)
    got = interop.frame_scene_from_numpy(jf, "cpu")
    for f in ("tri_verts", "tri_normals", "transforms", "inv_transforms"):
        assert getattr(got, f).dtype == torch.float32
        assert torch.equal(getattr(got, f), getattr(tf, f)), f
    _assert_device_scene_equal(jf.device, got.device)
    assert got.device.tri_vidx.dtype == torch.int64
    assert got.device.materials.is_light.dtype == torch.bool
