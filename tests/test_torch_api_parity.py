"""The functions that complete the port's public API against the JAX
package's, on the CPU, from numpy inputs made from a seed:

- `cmj_3d`, `cmj_4d`: bit-equal, on plain states and on states with the
  Sobol tag on half the lanes (JAX's `set_sobol_enabled` gate on, restored
  in a `finally`);
- `hemisphere_sampling`, `polar_to_xyz`, `transform_direction`,
  `lambert_eval`: rtol 1e-5, atol 1e-6 (sin, cos and sqrt differ by an ulp
  between XLA and torch);
- `affine_to_3x4`, `HALF_PI`, `Animation.get_translation_affine`: exact;
  `Animation.data_check` the same on a good track and on one whose keys
  and values differ in length;
- `build_atlas`: equal arrays (three textures, and the 1x1 white atlas of
  none); `sample_atlas`: atol 1e-6, with tex_id -1 on some lanes;
- `wavefront_pathtrace` on the sphere gallery (16x16, 2 spp, 1,024 lanes,
  max depth 4) against JAX's, which traces by brute force: the port by
  brute force and through its production intersector (`accel`: the plain
  binned version inside the sorted wrapper), at tests/test_torch_wavefront.py's
  limits (per-pixel RMSE of the mean colour <= 5e-3, sample and trace
  counts equal); and its `max_iters` cap against JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from henjou_torch import math as tmath
from henjou_torch.bsdf import lambert as tlam
from henjou_torch.sampling import cmj as tcmj
from henjou_torch.scene import animation as tanim
from henjou_torch.texture import atlas as tatlas
from henjou_torch.texture import texture as ttex
from henjou_tpu import math as jmath
from henjou_tpu.bsdf import lambert as jlam
from henjou_tpu.sampling import cmj as jcmj
from henjou_tpu.scene import animation as janim
from henjou_tpu.texture import atlas as jatlas
from henjou_tpu.texture import texture as jtex

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N_STATES = 1 << 14
TOL_RMSE = 5e-3
W = H = 16
SPP, LANES, MAX_DEPTH = 2, 1024, 4
CAM = ((0.0, 1.2, -9.0), (0.0, -0.05, 1.0), np.radians(45.0))
SKY = [0.3, 0.4, 0.55]
# the gallery has glass and metal, no sheen or clearcoat
FLAGS = dict(has_specular=True, has_metal=True, has_sheen=False, has_clearcoat=False)


def _u32(rng, n, hi=1 << 32):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("tagged", [False, True])
@pytest.mark.parametrize("draw", ["cmj_3d", "cmj_4d"])
def test_cmj_3d_4d_bit_equal_to_jax(draw, tagged):
    rng = np.random.default_rng(31)
    n_spp, pix = _u32(rng, N_STATES, 4096), _u32(rng, N_STATES)
    seeds = _u32(rng, N_STATES, 1 << 31)
    if tagged:
        seeds |= np.where(np.arange(N_STATES) % 2 == 0, tcmj.SOBOL_SEED_FLAG, 0).astype(np.uint32)
    jcmj.set_sobol_enabled(tagged)
    try:
        jst = jcmj.make_cmj_state(jnp.asarray(n_spp), jnp.asarray(pix), jnp.asarray(seeds))
        tst = tcmj.make_cmj_state(_t(n_spp), _t(pix), _t(seeds), sobol=tagged)
        for k in range(2):
            want, jst = getattr(jcmj, draw)(jst)
            got, tst = getattr(tcmj, draw)(tst)
            assert got.dtype == torch.float32 and np.array_equal(np.asarray(want), got.numpy()), k
            assert np.array_equal(np.asarray(jst.depth).astype(np.int64), tst.depth.numpy())
    finally:
        jcmj.set_sobol_enabled(False)


def _floats(rng, *shape, lo=0.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _close(want, got):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fn", ["hemisphere_sampling", "polar_to_xyz", "transform_direction",
                                "lambert_eval"])
def test_math_and_lambert_match_jax(fn):
    rng = np.random.default_rng(37)
    n = 4096
    if fn == "hemisphere_sampling":
        u, v = _floats(rng, n), _floats(rng, n)
        (jw, jp), (tw, tp) = jmath.hemisphere_sampling(u, v), tmath.hemisphere_sampling(
            torch.from_numpy(u), torch.from_numpy(v))
        _close(jw, tw)
        _close(jp, tp)
    elif fn == "polar_to_xyz":
        th, ph = _floats(rng, n, hi=np.pi), _floats(rng, n, lo=-np.pi, hi=np.pi)
        _close(jmath.polar_to_xyz(th, ph),
               tmath.polar_to_xyz(torch.from_numpy(th), torch.from_numpy(ph)))
    elif fn == "transform_direction":
        m, d = _floats(rng, n, 3, 4, lo=-2.0, hi=2.0), _floats(rng, n, 3, lo=-1.0, hi=1.0)
        _close(jmath.transform_direction(m, d),
               tmath.transform_direction(torch.from_numpy(m), torch.from_numpy(d)))
    else:
        bc, wo, wi = (_floats(rng, n, 3) for _ in range(3))
        _close(jlam.lambert_eval(jnp.asarray(bc), wo, wi),
               tlam.lambert_eval(*(torch.from_numpy(x) for x in (bc, wo, wi))))


def test_affine_constants_and_animation_match_jax():
    rng = np.random.default_rng(41)
    m4 = rng.normal(size=(4, 4))
    assert np.array_equal(tmath.affine_to_3x4(m4), jmath.affine_to_3x4(m4))
    assert tmath.affine_to_3x4(m4).dtype == np.float32
    from henjou_torch.math.constants import HALF_PI as t_half
    from henjou_tpu.math.constants import HALF_PI as j_half

    assert t_half == j_half
    keys = [0.0, 0.5, 1.5]
    vals = rng.normal(size=(3, 3)).astype(np.float32).tolist()
    ta = tanim.Animation(name="a", translation=tanim.AnimationTrack(keys=keys, values=vals))
    ja = janim.Animation(name="a", translation=janim.AnimationTrack(keys=keys, values=vals))
    for t in (-1.0, 0.0, 0.3, 0.5, 1.2, 2.0):
        got, want = ta.get_translation_affine(t), ja.get_translation_affine(t)
        assert got.dtype == want.dtype and np.array_equal(got, want), t
    assert ta.data_check() is ja.data_check() is True
    for a in (ta, ja):
        a.scale.keys = [0.0, 1.0]
        a.scale.values = [[1.0, 1.0, 1.0]]
    assert ta.data_check() is ja.data_check() is False


def _textures(module, rng):
    sizes = ((5, 7), (12, 4), (3, 70))
    return [module.Texture(name=f"t{k}", data=_floats(rng, h, w, 4),
                           tex_type=module.TexType.NON_COLOR) for k, (h, w) in enumerate(sizes)]


@pytest.mark.parametrize("n_tex", [0, 3])
def test_atlas_matches_jax(n_tex):
    texs = _textures(ttex, np.random.default_rng(43))[:n_tex]
    jtexs = [jtex.Texture(name=t.name, data=t.data, tex_type=jtex.TexType.NON_COLOR) for t in texs]
    ta, ja = tatlas.build_atlas(texs, "cpu"), jatlas.build_atlas(jtexs)
    for f in ("data", "offset", "size"):
        got, want = getattr(ta, f).numpy(), np.asarray(getattr(ja, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    rng = np.random.default_rng(47)
    n = 2048
    tex_id = rng.integers(-1, max(n_tex, 1), n).astype(np.int32)
    u, v = _floats(rng, n, lo=-3.0, hi=3.0), _floats(rng, n, lo=-3.0, hi=3.0)
    want = np.asarray(jatlas.sample_atlas(ja, jnp.asarray(tex_id), jnp.asarray(u), jnp.asarray(v)))
    got = tatlas.sample_atlas(ta, torch.from_numpy(tex_id), torch.from_numpy(u),
                              torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-6)
    assert (got[tex_id < 0] == 1.0).all() and (tex_id < 0).any()


@functools.lru_cache(maxsize=None)
def _jax_pathtrace(max_iters=None):
    from henjou_tpu.bsdf import dispatch as jdsp
    from henjou_tpu.integrator import payload as jpay
    from henjou_tpu.integrator.wavefront import wavefront_pathtrace
    from henjou_tpu.runtime import camera as jcam
    from henjou_tpu.scene import gltf as jgltf
    from henjou_tpu.scene import scenedata as jsd
    from henjou_tpu.texture import lut as jlut

    jf = jsd.build_frame_scene(jsd.build_device_scene(jgltf.load_gltf("scenes/sphere_gallery.gltf")))
    return jax.jit(lambda: wavefront_pathtrace(
        jf, jpay.Sky(constant_color=jnp.asarray(SKY), intensity=jnp.asarray(1.0)),
        jcam.make_camera(*CAM), W, H, SPP, jdsp.make_bsdf_sampler(jlut.default_lut(), **FLAGS),
        seed=0, lanes=LANES, max_depth=MAX_DEPTH, max_iters=max_iters))()


def _port_pathtrace(route, max_iters=None):
    from henjou_torch.accel.pallas_binned import pack_binned_np
    from henjou_torch.bsdf import dispatch as tdsp
    from henjou_torch.integrator import payload as tpay
    from henjou_torch.integrator.wavefront import wavefront_pathtrace
    from henjou_torch.runtime import camera as tcam
    from henjou_torch.scene import gltf as tgltf
    from henjou_torch.scene import scenedata as tsd
    from henjou_torch.texture import lut as tlut

    tf = tsd.build_frame_scene(tsd.build_device_scene(
        tgltf.load_gltf("scenes/sphere_gallery.gltf"), "cpu"))
    accel = pack_binned_np(tf.tri_verts.numpy(), "cpu") if route == "binned" else None
    return wavefront_pathtrace(
        tf, tpay.Sky(constant_color=torch.tensor(SKY), intensity=torch.tensor(1.0)),
        tcam.make_camera(*CAM, "cpu"), W, H, SPP,
        tdsp.make_bsdf_sampler(tlut.default_lut("cpu"), **FLAGS), seed=0, lanes=LANES,
        max_depth=MAX_DEPTH, max_iters=max_iters, accel=accel)


def _film_rmse(jfilm, tfilm):
    np.testing.assert_array_equal(np.asarray(jfilm.count), tfilm.count.numpy())
    assert int(tfilm.n_traces) == int(jfilm.n_traces)
    jc = np.asarray(jfilm.color) / np.maximum(np.asarray(jfilm.count), 1)[:, None]
    tc = tfilm.color.numpy() / np.maximum(tfilm.count.numpy(), 1)[:, None]
    assert np.isfinite(tc).all()
    return float(np.sqrt(((jc - tc) ** 2).mean())), tc


@pytest.mark.parametrize("route", ["binned", "brute"])
def test_wavefront_pathtrace_matches_jax(route):
    rmse, tc = _film_rmse(_jax_pathtrace(), _port_pathtrace(route))
    assert rmse <= TOL_RMSE, rmse
    assert tc.mean() > 0.05


def test_wavefront_pathtrace_max_iters_matches_jax():
    """A cap of 3 iterations cuts the render: the samples that finished
    by then, as in JAX's engine."""
    jfilm, tfilm = _jax_pathtrace(3), _port_pathtrace("brute", 3)
    assert 0 < int(tfilm.count.sum()) < W * H * SPP
    rmse, _ = _film_rmse(jfilm, tfilm)
    assert rmse <= TOL_RMSE, rmse
