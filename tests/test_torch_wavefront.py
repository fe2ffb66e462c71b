"""Port parity for the slice as a whole: the port's wavefront engine against
the JAX `wavefront_render` on the sphere gallery (16x16, 2 spp, 1,024
lanes, max_depth 4). The JAX side traces by brute force; the port runs
its production path on the CPU: the plain binned intersector inside the
sorted wrapper. Tolerance: per-pixel RMSE of the mean colour <= 5e-3 (the
two intersectors differ in the last ulp, which can flip a rare hit and
send one path elsewhere); sample counts and trace counts equal.

The pool re-sort (HENJOU_POOL_SORT, tests/test_wavefront.py:176): the
Cornell box at 16x16, 8 spp, 1,024 lanes by brute force, sorted by JAX's
test key after every bounce (27 columns through `bitonic_sort`), against
the unsorted port (JAX's limits: rtol 1e-4, atol 1e-5, traces equal) and
against JAX's sorted film (the limits above); and the Renderer's route
(raw binned kernels and a pool key only for power-of-two lanes of at
least 1024)."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from henjou_torch.accel.pallas_binned import make_binned_intersector, pack_binned_np
from henjou_torch.accel.sorting import make_bitonic_sorted_intersector
from henjou_torch.bsdf import dispatch as tdsp
from henjou_torch.integrator import payload as tpay
from henjou_torch.integrator.wavefront import wavefront_render as t_render
from henjou_torch.runtime import camera as tcam
from henjou_torch.scene import gltf as tgltf
from henjou_torch.scene import scenedata as tsd
from henjou_torch.texture import lut as tlut
from henjou_tpu.bsdf import dispatch as jdsp
from henjou_tpu.integrator import payload as jpay
from henjou_tpu.integrator.wavefront import wavefront_render as j_render
from henjou_tpu.runtime import camera as jcam
from henjou_tpu.scene import gltf as jgltf
from henjou_tpu.scene import scenedata as jsd
from henjou_tpu.texture import lut as jlut

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 16
SPP, LANES, MAX_DEPTH = 2, 1024, 4
CAM = ((0.0, 1.2, -9.0), (0.0, -0.05, 1.0), np.radians(45.0))
SKY = [0.3, 0.4, 0.55]
TOL_RMSE = 5e-3
# the gallery has glass and metal, no sheen or clearcoat
FLAGS = dict(has_specular=True, has_metal=True, has_sheen=False, has_clearcoat=False)


@functools.lru_cache(maxsize=None)
def _port_setup():
    tf = tsd.build_frame_scene(tsd.build_device_scene(tgltf.load_gltf("scenes/sphere_gallery.gltf"), "cpu"))
    bc = pack_binned_np(tf.tri_verts.numpy(), "cpu")
    ifn, ofn = make_bitonic_sorted_intersector(*make_binned_intersector(bc), bc.scene_lo, bc.scene_hi)
    return tf, ifn, ofn


def _port(integrator, **kw):
    tf, ifn, ofn = _port_setup()
    lut = tlut.default_lut("cpu")
    flags = dict(has_sheen=False, has_clearcoat=False)
    return t_render(
        tf, tpay.Sky(constant_color=torch.tensor(SKY), intensity=torch.tensor(1.0)),
        tcam.make_camera(*CAM, "cpu"), W, H, SPP, tdsp.make_bsdf_sampler(lut, **FLAGS),
        bsdf_eval=lambda h, wo, wi: tdsp.bsdf_eval(h, wo, wi, lut, **flags),
        bsdf_pdf=tdsp.bsdf_pdf, integrator=integrator, seed=0, lanes=LANES,
        max_depth=MAX_DEPTH, intersect_fn=ifn, occluded_fn=ofn,
        mis_single=integrator == "mis", **kw,
    )


def _jax(integrator, **kw):
    jf = jsd.build_frame_scene(jsd.build_device_scene(jgltf.load_gltf("scenes/sphere_gallery.gltf")))
    lut = jlut.default_lut()
    flags = dict(has_sheen=False, has_clearcoat=False)
    fn = jax.jit(lambda: j_render(
        jf, jpay.Sky(constant_color=jnp.asarray(SKY), intensity=jnp.asarray(1.0)),
        jcam.make_camera(*CAM), W, H, SPP, jdsp.make_bsdf_sampler(lut, **FLAGS),
        bsdf_eval=lambda h, wo, wi: jdsp.bsdf_eval(h, wo, wi, lut, **flags),
        bsdf_pdf=jdsp.bsdf_pdf, integrator=integrator, seed=0, lanes=LANES,
        max_depth=MAX_DEPTH, mis_single=integrator == "mis", **kw,
    ))
    return fn()


@pytest.mark.parametrize("integrator", ["mis", "nee"])
def test_slice_matches_jax_wavefront(integrator):
    jfilm = _jax(integrator)
    tfilm = _port(integrator)
    np.testing.assert_array_equal(np.asarray(jfilm.count), tfilm.count.numpy())
    assert int(tfilm.n_traces) == int(jfilm.n_traces)
    jc = np.asarray(jfilm.color) / np.asarray(jfilm.count)[:, None]
    tc = tfilm.color.numpy() / tfilm.count.numpy()[:, None]
    rmse = float(np.sqrt(((jc - tc) ** 2).mean()))
    assert rmse <= TOL_RMSE, rmse
    assert np.isfinite(tc).all() and tc.mean() > 0.05
    for f in ("albedo", "normal"):
        a = np.asarray(getattr(jfilm, f)) / SPP
        b = getattr(tfilm, f).numpy() / SPP
        assert float(np.sqrt(((a - b) ** 2).mean())) <= TOL_RMSE, f


def test_chunked_render_equals_unchunked():
    """Pixel chunks key the CMJ stream and camera rays on the global pixel
    id, so a chunked render equals an unchunked one bitwise."""
    whole = _port("mis")
    parts = [_port("mis", pixel_base=b, pixel_count=c) for b, c in ((0, 100), (100, 156))]
    for f in ("color", "albedo", "normal", "m2", "count"):
        got = torch.cat([getattr(p, f) for p in parts])
        assert torch.equal(got, getattr(whole, f)), f


def _cornell_pool(pool, jax_side=False):
    """The Cornell box at 16x16, 8 spp, 1,024 lanes, by brute force, with
    or without the pool re-sort keyed on JAX's test key
    (tests/test_wavefront.py:176)."""
    from henjou_torch.accel.sorting import ray_sort_key as t_key
    from henjou_torch.scene import testscenes as tscenes
    from henjou_tpu.accel.sorting import ray_sort_key as j_key
    from henjou_tpu.scene import testscenes as jscenes

    cam = ((0, 0, -4.5), (0, 0, 1), np.radians(45.0))
    if jax_side:
        frame = jsd.build_frame_scene(jsd.build_device_scene(jscenes.cornell_box_scene()))
        lo, inv_e = jnp.asarray([-2.0] * 3), jnp.asarray([0.25] * 3)
        key = (lambda o, d: j_key(o, d, lo, inv_e)) if pool else None
        return jax.jit(lambda: j_render(
            frame, jpay.Sky(constant_color=jnp.zeros(3), intensity=jnp.asarray(1.0)),
            jcam.make_camera(*cam), 16, 16, 8, jdsp.make_bsdf_sampler(None), seed=0,
            lanes=1024, pool_key_fn=key))()
    frame = tsd.build_frame_scene(tsd.build_device_scene(tscenes.cornell_box_scene(), "cpu"))
    lo, inv_e = torch.full((3,), -2.0), torch.full((3,), 0.25)
    return t_render(frame, tpay.Sky(constant_color=torch.zeros(3), intensity=torch.tensor(1.0)),
                    tcam.make_camera(*cam, "cpu"), 16, 16, 8, tdsp.make_bsdf_sampler(None),
                    seed=0, lanes=1024,
                    pool_key_fn=(lambda o, d: t_key(o, d, lo, inv_e)) if pool else None)


def test_pool_sort_is_estimator_invariant():
    """The whole pool sorted after every bounce (27 columns through
    `bitonic_sort`) leaves the estimate as it was: lane order is free
    (JAX's limits, rtol 1e-4, atol 1e-5; traces equal)."""
    from henjou_torch.accel import bitonic

    calls = []
    real = bitonic.bitonic_sort_plain

    def counted(key, *planes):
        calls.append(sum(1 if p.dim() == 1 else p.shape[1] for p in planes))
        return real(key, *planes)

    bitonic.bitonic_sort_plain = counted
    try:
        sorted_ = _cornell_pool(True)
    finally:
        bitonic.bitonic_sort_plain = real
    base = _cornell_pool(False)
    assert calls and set(calls) == {27}
    np.testing.assert_allclose(sorted_.color.numpy(), base.color.numpy(), rtol=1e-4, atol=1e-5)
    assert int(sorted_.n_traces) == int(base.n_traces)
    assert torch.equal(sorted_.count, base.count)


def test_pool_sort_matches_jax_sorted():
    """The port's pool-sorted film against JAX's (its Pallas sort in
    interpret mode), with this file's limits."""
    want, got = _cornell_pool(True, jax_side=True), _cornell_pool(True)
    assert int(got.n_traces) == int(want.n_traces)
    np.testing.assert_array_equal(np.asarray(want.count), got.count.numpy())
    rmse = float(np.sqrt(((np.asarray(want.color) - got.color.numpy()) ** 2).mean())) / 8
    assert rmse <= TOL_RMSE, rmse


def test_renderer_pool_sort_route(monkeypatch):
    """HENJOU_POOL_SORT=1 gives the wavefront engine the raw binned
    kernels and a pool key, for power-of-two lanes of at least 1024 only;
    the Renderer's film equals the per-trace sorted one within JAX's
    limits."""
    from henjou_torch.runtime.renderer import Renderer
    from henjou_torch.runtime.scene_accel import SceneAccel

    monkeypatch.chdir(ROOT)

    def render():
        r = Renderer(device="cpu")
        r.load_render_option("scenes/sphere_gallery_option.json")
        r.option = dataclasses.replace(r.option, image_width=W, image_height=H, max_spp=2)
        r._load_scene_from_option()
        return r, r.render_frame(0)

    r, base = render()
    accel = r.frame_scene(0)[1]
    assert SceneAccel.wavefront_trace_fns(accel, 4096)[2] is None
    monkeypatch.setenv("HENJOU_POOL_SORT", "1")
    assert SceneAccel.wavefront_trace_fns(accel, 4096)[2] is not None
    assert SceneAccel.wavefront_trace_fns(accel, 3072)[2] is None
    assert SceneAccel.wavefront_trace_fns(None, 4096)[2] is None
    _, pooled = render()
    np.testing.assert_allclose(pooled["color"], base["color"], rtol=1e-4, atol=1e-5)
    assert pooled["n_traces"] == base["n_traces"]
