"""Port parity for the slice as a whole: the port's wavefront engine against
the JAX `wavefront_render` on the sphere gallery (16x16, 2 spp, 1,024
lanes, max_depth 4). The JAX side traces by brute force; the port runs
its production path on the CPU: the plain binned intersector inside the
sorted wrapper. Tolerance: per-pixel RMSE of the mean colour <= 5e-3 (the
two intersectors differ in the last ulp, which can flip a rare hit and
send one path elsewhere); sample counts and trace counts equal."""

import functools

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


def _jax(integrator):
    jf = jsd.build_frame_scene(jsd.build_device_scene(jgltf.load_gltf("scenes/sphere_gallery.gltf")))
    lut = jlut.default_lut()
    flags = dict(has_sheen=False, has_clearcoat=False)
    fn = jax.jit(lambda: j_render(
        jf, jpay.Sky(constant_color=jnp.asarray(SKY), intensity=jnp.asarray(1.0)),
        jcam.make_camera(*CAM), W, H, SPP, jdsp.make_bsdf_sampler(lut, **FLAGS),
        bsdf_eval=lambda h, wo, wi: jdsp.bsdf_eval(h, wo, wi, lut, **flags),
        bsdf_pdf=jdsp.bsdf_pdf, integrator=integrator, seed=0, lanes=LANES,
        max_depth=MAX_DEPTH, mis_single=integrator == "mis",
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


@pytest.mark.parametrize("kw", [dict(light_ris=4), dict(pool_key_fn=lambda o, d: 0)])
def test_unported_options_raise(kw):
    tf, _, _ = _port_setup()
    args = dict(integrator="mis", mis_single=True, bsdf_eval=tdsp.bsdf_eval, bsdf_pdf=tdsp.bsdf_pdf)
    args.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_render(tf, tpay.Sky(constant_color=torch.zeros(3), intensity=torch.tensor(1.0)),
                 tcam.make_camera(*CAM, "cpu"), W, H, SPP, tdsp.make_bsdf_sampler(None), **args)
