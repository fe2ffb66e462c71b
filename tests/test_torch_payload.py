"""Port parity: the surface fetch (every SurfaceHit field), `sample_light`
and `light_pdf`, on the gallery and on contest frame 0 (textures, IBL
sky, power-weighted light selection). Floats to rtol 1e-5 / atol 1e-6,
integers and flags exactly."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from henjou_torch.accel import pallas_binned as tpb
from henjou_torch.integrator import payload as tpay
from henjou_torch.sampling import cmj as tcmj
from henjou_torch.sampling import light_sample as tls
from henjou_torch.texture.ibl import load_ibl as t_load_ibl
from henjou_tpu.integrator import payload as jpay
from henjou_tpu.sampling import cmj as jcmj
from henjou_tpu.sampling import light_sample as jls
from henjou_tpu.scene import gltf as jgltf
from henjou_tpu.scene import scenedata as jsd
from henjou_tpu.texture.ibl import load_ibl as j_load_ibl

from tests import torch_interop as interop

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N = 2048


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(JAX frame, port frame via interop, JAX sky, port sky)."""
    if name == "gallery":
        js = jgltf.load_gltf("scenes/sphere_gallery.gltf")
        jsky = jpay.Sky(constant_color=jnp.asarray([0.3, 0.4, 0.55]), intensity=jnp.asarray(1.0))
        tsky = tpay.Sky(constant_color=torch.tensor([0.3, 0.4, 0.55]), intensity=torch.tensor(1.0))
    else:
        js = jgltf.load_gltf("scenes/rtcamp.gltf")
        hdr = "scenes/rtcamp_sky.hdr"
        jsky = jpay.Sky(constant_color=jnp.asarray([0.2, 0.25, 0.35]), intensity=jnp.asarray(1.0),
                        use_ibl=True, ibl_texture=j_load_ibl(hdr))
        tsky = tpay.Sky(constant_color=torch.tensor([0.2, 0.25, 0.35]), intensity=torch.tensor(1.0),
                        use_ibl=True, ibl_texture=t_load_ibl(hdr, "cpu"))
    jf = jsd.build_frame_scene(jsd.build_device_scene(js))
    return jf, interop.frame_scene_from_numpy(jf, "cpu"), jsky, tsky


def _rays(tf, seed):
    """Half rays from inside the scene box in random directions, half aimed
    at random triangle centroids from outside the box (mostly hits)."""
    rng = np.random.default_rng(seed)
    tv = tf.tri_verts.numpy()
    lo, hi = tv.reshape(-1, 3).min(0), tv.reshape(-1, 3).max(0)
    o1 = rng.uniform(lo, hi, (N // 2, 3))
    d1 = rng.normal(size=(N // 2, 3))
    tgt = tv[rng.integers(0, len(tv), N // 2)].mean(1)
    o2 = tgt + rng.normal(size=(N // 2, 3)) * (hi - lo).max()
    d2 = tgt - o2
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([d1, d2])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _cmp(jv, tv, what):
    a = np.asarray(jv)
    b = tv.numpy()
    if a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(b.astype(np.int64), a.astype(np.int64), err_msg=what)


@pytest.mark.parametrize("name", ["gallery", "contest"])
def test_surface_hit_fields(name):
    """Both fetches get the same intersection results (the port's plain
    binned intersector), so this checks the fetch alone, all 21 fields."""
    jf, tf, jsky, tsky = _scene(name)
    o, d = _rays(tf, 1)
    bc = tpb.pack_binned_np(tf.tri_verts.numpy(), "cpu")
    t, prim, u, v, hit = tpb.intersect_binned(bc, o, d, 1e-3)
    assert 0.2 < float(hit.float().mean()) < 0.95

    def jfn(*_):
        return (jnp.asarray(t.numpy()), jnp.asarray(prim.numpy()), jnp.asarray(u.numpy()),
                jnp.asarray(v.numpy()), jnp.asarray(hit.numpy()))

    jh = jpay.closest_hit(jf, jsky, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), intersect_fn=jfn)
    th = tpay.closest_hit(tf, tsky, o, d, intersect_fn=lambda *_: (t, prim, u, v, hit))
    assert jh._fields == th._fields and len(th._fields) == 21
    for f in th._fields:
        _cmp(getattr(jh, f), getattr(th, f), f)


@pytest.mark.parametrize("strategy", ["power", "uniform"])
@pytest.mark.parametrize("name", ["gallery", "contest"])
def test_sample_light_and_light_pdf(name, strategy, monkeypatch):
    jf, tf, _, _ = _scene(name)
    monkeypatch.setattr(jls, "LIGHT_SAMPLING", strategy)
    monkeypatch.setenv("HENJOU_LIGHT_SAMPLING", strategy)
    rng = np.random.default_rng(2)
    spp = rng.integers(0, 1024, N).astype(np.uint32)
    pix = rng.integers(0, 2**20, N).astype(np.uint32)
    js = jcmj.make_cmj_state(jnp.asarray(spp), jnp.asarray(pix), 9)
    ts = tcmj.make_cmj_state(torch.from_numpy(spp.astype(np.int64)),
                             torch.from_numpy(pix.astype(np.int64)), 9)
    jo = jls.sample_light(jf, js)
    to = tls.sample_light(tf, ts)
    for what, a, b in zip(("position", "normal", "emission", "pdf", "valid"), jo[:5], to[:5]):
        _cmp(a, b, what)
    np.testing.assert_array_equal(np.asarray(jo[5].depth).astype(np.int64), to[5].depth.numpy())
    prim = rng.integers(-1, tf.tri_verts.shape[0], N)
    lights = tf.device.light_prim_ids.numpy()
    prim[: N // 2] = lights[rng.integers(0, len(lights), N // 2)]
    _cmp(jls.light_pdf(jf, jnp.asarray(prim.astype(np.int32))),
         tls.light_pdf(tf, torch.from_numpy(prim)), "light_pdf")
