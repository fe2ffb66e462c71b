"""Port parity of two-sample MIS (``mis_mode="ref"``): the argsort-sorted
wrapper, the dense and binned light queries, and the two-sample wavefront
engine against the JAX package.

Tolerances: the sorted wrapper changes nothing (equal tensors); the light
queries keep hit flags and prims equal, t within a relative 1e-5 and the
light's area within a relative 1e-5 (the binned query is a different
formula, Baldwin-Weber, so its t is held at 1e-4, as the JAX package's
own test holds it, tests/test_light_scaling.py); the engine keeps sample
and trace counts equal and the per-pixel mean within RMSE 5e-3, as
tests/test_torch_wavefront.py does for the one-sample form."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from henjou_torch.accel import pallas_binned as tpb
from henjou_torch.accel import pallas_cluster as tpc
from henjou_torch.accel import pallas_cluster_hbm as thbm
from henjou_torch.accel import pallas_mxu as tmxu
from henjou_torch.accel import sorting as tsort
from henjou_torch.accel.pallas_binned import make_binned_intersector, pack_binned_np
from henjou_torch.accel.sorting import make_bitonic_sorted_intersector
from henjou_torch.bsdf import dispatch as tdsp
from henjou_torch.integrator import payload as tpay
from henjou_torch.integrator.wavefront import wavefront_render as t_render
from henjou_torch.runtime import camera as tcam
from henjou_torch.sampling import light_sample as tls
from henjou_torch.sampling.cmj import make_cmj_state
from henjou_torch.scene import gltf as tgltf
from henjou_torch.scene import scenedata as tsd
from henjou_torch.texture import lut as tlut
from henjou_tpu.bsdf import dispatch as jdsp
from henjou_tpu.integrator import payload as jpay
from henjou_tpu.integrator.wavefront import wavefront_render as j_render
from henjou_tpu.runtime import camera as jcam
from henjou_tpu.sampling import light_sample as jls
from henjou_tpu.scene import gltf as jgltf
from henjou_tpu.scene import scenedata as jsd
from henjou_tpu.texture import lut as jlut

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

GALLERY = "scenes/sphere_gallery.gltf"
W = H = 16
SPP, LANES, MAX_DEPTH = 2, 1024, 4
CAM = ((0.0, 1.2, -9.0), (0.0, -0.05, 1.0), np.radians(45.0))
SKY = [0.3, 0.4, 0.55]
TOL_RMSE = 5e-3
FLAGS = dict(has_specular=True, has_metal=True, has_sheen=False, has_clearcoat=False)


@functools.lru_cache(maxsize=None)
def _gallery():
    """(port frame scene, JAX frame scene, camera and random rays [2048])."""
    tf = tsd.build_frame_scene(tsd.build_device_scene(tgltf.load_gltf(GALLERY), "cpu"))
    jf = jsd.build_frame_scene(jsd.build_device_scene(jgltf.load_gltf(GALLERY)))
    rng = np.random.default_rng(21)
    cam = tcam.make_camera(*CAM, "cpu")
    pix = torch.from_numpy(rng.integers(0, 512 * 288, 1024))
    o_c, d_c, _ = tcam.camera_rays(cam, 512, 288, pix, make_cmj_state(0, pix, 0))
    lo, hi = tf.tri_verts.reshape(-1, 3).amin(0), tf.tri_verts.reshape(-1, 3).amax(0)
    o_r = rng.uniform(lo.numpy(), hi.numpy(), (1024, 3)).astype(np.float32)
    d_r = rng.normal(size=(1024, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    o = torch.cat([o_c, torch.from_numpy(o_r)]).contiguous()
    d = torch.cat([d_c, torch.from_numpy(d_r)]).contiguous()
    return tf, jf, o, d


def _many_light_arrays(n_panels=550):
    """A floor and n_panels emissive quads (1,100 light triangles), as
    tests/test_light_scaling.py builds it: (vertices, normals, material
    ids) for both packages' SceneData."""
    rng = np.random.default_rng(2)
    s = 10.0
    verts = [np.asarray([[-s, -1, -s], [-s, -1, s], [s, -1, s],
                         [-s, -1, -s], [s, -1, s], [s, -1, -s]], np.float32)]
    norms = [np.tile(np.asarray([[0, 1, 0]], np.float32), (6, 1))]
    mids = [0, 0]
    for _ in range(n_panels):
        c = rng.uniform(-8, 8, 3).astype(np.float32)
        c[1] = rng.uniform(1.0, 6.0)
        w = 0.15
        verts.append(np.asarray([
            [c[0] - w, c[1], c[2] - w], [c[0] + w, c[1], c[2] - w], [c[0] + w, c[1], c[2] + w],
            [c[0] - w, c[1], c[2] - w], [c[0] + w, c[1], c[2] + w], [c[0] - w, c[1], c[2] + w],
        ], np.float32))
        norms.append(np.tile(np.asarray([[0, -1, 0]], np.float32), (6, 1)))
        mids += [1, 1]
    return np.concatenate(verts), np.concatenate(norms), np.asarray(mids, np.uint32)


@functools.lru_cache(maxsize=None)
def _many_lights():
    """(port frame, JAX frame, rays [1024]) of the many-light scene."""
    v, n, mids = _many_light_arrays()
    frames = []
    for sd in (tsd, jsd):
        mats = [sd.make_material("floor", base_color=(0.7, 0.7, 0.7), roughness=0.8),
                sd.make_material("light", emission=(5.0, 4.0, 3.0), is_light=True)]
        scene = sd.SceneData(vertices=v, indices=np.arange(len(v), dtype=np.uint32),
                             material_ids=mids, normals=n, texcoords=None, colors=None,
                             materials=mats)
        frames.append(sd.build_frame_scene(
            sd.build_device_scene(scene, "cpu") if sd is tsd else sd.build_device_scene(scene)))
    rng = np.random.default_rng(4)
    o = rng.uniform(-9, 9, (1024, 3)).astype(np.float32)
    o[:, 1] = -0.5
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1]) + 0.2  # look up at the panels
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return frames[0], frames[1], torch.from_numpy(o), torch.from_numpy(d)


def _agree(ref, got, t_rel):
    r_t, r_p, _, _, r_h, r_a = (np.asarray(x) for x in ref)
    g_t, g_p, _, _, g_h, g_a = (x.numpy() for x in got)
    np.testing.assert_array_equal(g_h, r_h)
    np.testing.assert_array_equal(g_p, r_p)
    np.testing.assert_allclose(g_t[g_h], r_t[g_h], rtol=t_rel)
    np.testing.assert_allclose(g_a[g_h], r_a[g_h], rtol=1e-5)
    assert np.isinf(g_t[~g_h]).all() and (g_a[~g_h] == 0).all()
    return int(g_h.sum())


@pytest.mark.parametrize("scene", ["gallery", "many_lights"])
def test_intersect_lights_matches(scene):
    """Dense light query against the JAX `intersect_lights` (the gallery's
    2 lights, and 1,100 lights in three chunks of up to 512)."""
    tf, jf, o, d = _gallery() if scene == "gallery" else _many_lights()
    tmax = torch.full((o.shape[0],), 1e9)
    got = tls.intersect_lights(tf, o, d, 1e-3, tmax)
    ref = jls.intersect_lights(jf, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), 1e-3,
                               jnp.asarray(tmax.numpy()))
    assert _agree(ref, got, 1e-5) > 20


def test_binned_light_query_matches():
    """The binned light query over the emissive subset (kernel 1's plain
    version on CPU tensors) against the JAX one (Pallas in interpret mode)
    on 1,100 lights, and against the port's dense query."""
    tf, jf, o, d = _many_lights()
    la = tls.build_light_accel(tf.tri_verts.numpy(), tf.device.light_prim_ids.numpy(), "cpu")
    jla = jls.build_light_accel(np.asarray(jf.tri_verts), np.asarray(jf.device.light_prim_ids))
    assert la.bc.num_clusters == jla.bc.num_clusters == 9
    before = tpb.LAUNCHES
    got = tls.make_binned_light_intersector(la)(tf, o, d, 1e-3, 1e9)
    assert tpb.LAUNCHES == before
    ref = jls.make_binned_light_intersector(jla, interpret=True)(
        jf, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), 1e-3, 1e9)
    assert _agree(ref, got, 1e-5) > 50
    dense = tls.intersect_lights(tf, o, d, 1e-3, 1e9)
    _agree(tuple(x.numpy() for x in dense), got, 1e-4)


@pytest.mark.parametrize("kind", ["flat", "hbm", "mxu"])
def test_sorted_wrapper_is_invisible(kind):
    """The argsort wrapper around each cluster intersector (plain versions
    on CPU tensors) changes nothing per ray, for closest and any hit."""
    tf, _, o, d = _gallery()
    tv = tf.tri_verts
    if kind == "flat":
        fns = tpc.make_pallas_intersector(tpc.pack_clusters(tv))
    elif kind == "hbm":
        fns = thbm.make_pallas_hbm_intersector(thbm.pack_clusters_hbm_np(tv.numpy(), "cpu"))
    else:
        fns = tmxu.make_pallas_mxu_intersector(tmxu.pack_clusters_mxu_np(tv.numpy(), "cpu"))
    lo, hi = tv.reshape(-1, 3).amin(0), tv.reshape(-1, 3).amax(0)
    sifn, sofn = tsort.make_sorted_intersector(*fns, lo, hi)
    tmax = torch.where(torch.arange(o.shape[0]) % 7 == 0, 0.0, 50.0)  # some dead lanes
    ref = fns[0](None, o, d, 1e-3, tmax)
    for a, b in zip(ref, sifn(None, o, d, 1e-3, tmax)):
        assert torch.equal(a, b)
    assert int(ref[4].sum()) > 600
    assert torch.equal(fns[1](None, o, d, 1e-3, tmax), sofn(None, o, d, 1e-3, tmax))


def _port_render(light_isect_fn=None):
    tf, _, _, _ = _gallery()
    bc = pack_binned_np(tf.tri_verts.numpy(), "cpu")
    ifn, ofn = make_bitonic_sorted_intersector(*make_binned_intersector(bc), bc.scene_lo, bc.scene_hi)
    lut = tlut.default_lut("cpu")
    flags = dict(has_sheen=False, has_clearcoat=False)
    return t_render(
        tf, tpay.Sky(constant_color=torch.tensor(SKY), intensity=torch.tensor(1.0)),
        tcam.make_camera(*CAM, "cpu"), W, H, SPP, tdsp.make_bsdf_sampler(lut, **FLAGS),
        bsdf_eval=lambda h, wo, wi: tdsp.bsdf_eval(h, wo, wi, lut, **flags),
        bsdf_pdf=tdsp.bsdf_pdf, integrator="mis", seed=0, lanes=LANES,
        max_depth=MAX_DEPTH, intersect_fn=ifn, occluded_fn=ofn, mis_single=False,
        light_isect_fn=light_isect_fn,
    )


@functools.lru_cache(maxsize=None)
def _jax_render():
    _, jf, _, _ = _gallery()
    lut = jlut.default_lut()
    flags = dict(has_sheen=False, has_clearcoat=False)
    fn = jax.jit(lambda: j_render(
        jf, jpay.Sky(constant_color=jnp.asarray(SKY), intensity=jnp.asarray(1.0)),
        jcam.make_camera(*CAM), W, H, SPP, jdsp.make_bsdf_sampler(lut, **FLAGS),
        bsdf_eval=lambda h, wo, wi: jdsp.bsdf_eval(h, wo, wi, lut, **flags),
        bsdf_pdf=jdsp.bsdf_pdf, integrator="mis", seed=0, lanes=LANES,
        max_depth=MAX_DEPTH, mis_single=False,
    ))
    return fn()


@pytest.mark.parametrize("light_query", ["dense", "binned"])
def test_two_sample_wavefront_matches_jax(light_query):
    """The port's two-sample engine (plain binned intersector in the
    bitonic sorted wrapper; the light query dense, or binned over the
    gallery's 2 lights) against the JAX `wavefront_render(mis_single=
    False)`, which traces by brute force with the dense light query."""
    lfn = None
    if light_query == "binned":
        tf, _, _, _ = _gallery()
        lfn = tls.make_binned_light_intersector(tls.build_light_accel(
            tf.tri_verts.numpy(), tf.device.light_prim_ids.numpy(), "cpu"))
    jfilm = _jax_render()
    tfilm = _port_render(lfn)
    np.testing.assert_array_equal(np.asarray(jfilm.count), tfilm.count.numpy())
    assert int(tfilm.n_traces) == int(jfilm.n_traces)
    jc = np.asarray(jfilm.color) / np.asarray(jfilm.count)[:, None]
    tc = tfilm.color.numpy() / tfilm.count.numpy()[:, None]
    rmse = float(np.sqrt(((jc - tc) ** 2).mean()))
    assert rmse <= TOL_RMSE, rmse
    assert np.isfinite(tc).all() and tc.mean() > 0.05


def test_scale_test_tool_runs_both_rows():
    """henjou_torch.tools.scale_test at a tiny size on the CPU: both rows
    (binned+bitonic, and the two-level intersector in the argsort
    wrapper) render the same two-sample image with the same traces."""
    from henjou_torch.tools.scale_test import ROWS, run_scale_test

    out = run_scale_test("cpu", 24, 16, 1, 1024, lat=8, lon=12, log=lambda *a: None)
    assert out["scene"]["tris"] == 172 and out["scene"]["super"] == 1
    rows = [out["rows"][name] for name in ROWS]
    assert all(r["film_finite"] and r["traces"] > 24 * 16 for r in rows)
    assert rows[0]["traces"] == rows[1]["traces"]
    assert out["rmse"] <= TOL_RMSE and float(rows[0]["mean"].mean()) > 0.05
