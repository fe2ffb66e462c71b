"""The masked depth-loop engine of the port against the JAX package's.

1. The port's `pathtrace`, `nee` and `mis` against the JAX functions on
   the same camera rays and CMJ states: the Cornell box (brute force,
   Lambertian), 16x16, 4 spp, each spp's per-lane radiance and AOVs within
   rtol 1e-4, atol 1e-5 (the two packages' f32 arithmetic differs in the
   last bits), trace counts equal.
2. `Renderer(engine="masked")` against `engine="wavefront",
   mis_mode="ref"` for all three integrators (the same CMJ streams), the
   same limits (tests/test_wavefront.py:116).
3. The two pinned goldens rendered by the port's masked engine, RMSE < 2.0
   on 8-bit sRGB (tests/test_golden_headline.py:23,
   tests/test_render_modes.py:153).
4. A masked checkpoint resumed mid-frame equals an uninterrupted render,
   and the wavefront engine resumes it too (one checkpoint form).
5. tools/profile_step.py at a toy size.
6. The test scenes the port copies (`furnace_scene`,
   `thinfilm_sweep_scene`, `headline_mini_scene`) field-equal to the JAX
   package's, and the white furnace (tests/test_pathtrace.py:60) through
   the port's `pathtrace`: an albedo-1 sphere in a sky of radiance 1 renders
   1.0 within 0.03, its mean within 1e-3 of JAX's on the same lanes.
"""

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from henjou_torch.bsdf import dispatch as tdsp
from henjou_torch.integrator import payload as tpay
from henjou_torch.integrator.mis import mis as t_mis
from henjou_torch.integrator.nee import nee as t_nee
from henjou_torch.integrator.pathtrace import pathtrace as t_pathtrace
from henjou_torch.post.png import read_png
from henjou_torch.post.srgb import float_to_srgb_u8
from henjou_torch.runtime.options import RenderOption
from henjou_torch.runtime.renderer import Renderer
from henjou_torch.sampling.cmj import make_cmj_state as t_cmj_state
from henjou_torch.scene import scenedata as tsd
from henjou_torch.scene import testscenes as tscenes
from henjou_tpu.bsdf import dispatch as jdsp
from henjou_tpu.integrator import payload as jpay
from henjou_tpu.integrator.mis import mis as j_mis
from henjou_tpu.integrator.nee import nee as j_nee
from henjou_tpu.integrator.pathtrace import pathtrace as j_pathtrace
from henjou_tpu.runtime import camera as jcam
from henjou_tpu.sampling.cmj import make_cmj_state as j_cmj_state
from henjou_tpu.scene import scenedata as jsd
from henjou_tpu.scene import testscenes as jscenes

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
W = H = 16
SPP = 4
CORNELL_CAM = dict(camera_position=(0.0, 0.0, -4.5), camera_direction=(0.0, 0.0, 1.0))


@functools.lru_cache(maxsize=None)
def _scenes():
    jf = jsd.build_frame_scene(jsd.build_device_scene(jscenes.cornell_box_scene()))
    tf = tsd.build_frame_scene(tsd.build_device_scene(tscenes.cornell_box_scene(), "cpu"))
    return jf, tf


def _lane_inputs(s):
    """Spp `s`'s camera rays and post-camera CMJ states of every pixel, from
    the JAX package, as JAX arrays and as the port's tensors."""
    cam = jcam.make_camera(CORNELL_CAM["camera_position"], CORNELL_CAM["camera_direction"],
                           np.radians(45.0))
    pix = jnp.arange(W * H, dtype=jnp.uint32)
    st = j_cmj_state(jnp.full(W * H, s, jnp.uint32), pix, 0)
    o, d, st = jcam.camera_rays(cam, W, H, pix, st)
    t_st = t_cmj_state(torch.full((W * H,), s), torch.arange(W * H), 0)
    t_st = t_st._replace(depth=torch.from_numpy(np.asarray(st.depth).astype(np.int64)))
    return (o, d, st), (torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)), t_st)


def _integrators(integrator):
    """(jitted JAX function, port function), each of (o, d, state)."""
    jf, tf = _scenes()
    jsky = jpay.Sky(constant_color=jnp.zeros(3), intensity=jnp.asarray(1.0))
    tsky = tpay.Sky(constant_color=torch.zeros(3), intensity=torch.tensor(1.0))
    jsample, tsample = jdsp.make_bsdf_sampler(None), tdsp.make_bsdf_sampler(None)
    jeval = lambda h, wo, wi: jdsp.bsdf_eval(h, wo, wi, None)
    teval = lambda h, wo, wi: tdsp.bsdf_eval(h, wo, wi, None)
    if integrator == "pathtrace":
        return (jax.jit(lambda o, d, st: j_pathtrace(jf, jsky, o, d, st, jsample)),
                lambda o, d, st: t_pathtrace(tf, tsky, o, d, st, tsample))
    if integrator == "nee":
        return (jax.jit(lambda o, d, st: j_nee(jf, jsky, o, d, st, jsample, jeval)),
                lambda o, d, st: t_nee(tf, tsky, o, d, st, tsample, teval))
    return (jax.jit(lambda o, d, st: j_mis(jf, jsky, o, d, st, jsample, jeval, jdsp.bsdf_pdf)),
            lambda o, d, st: t_mis(tf, tsky, o, d, st, tsample, teval, tdsp.bsdf_pdf))


@pytest.mark.parametrize("integrator", ["pathtrace", "nee", "mis"])
def test_integrator_matches_jax_per_lane(integrator):
    j_fn, t_fn = _integrators(integrator)
    for s in range(SPP):
        j_in, t_in = _lane_inputs(s)
        want, got = j_fn(*j_in), t_fn(*t_in)
        for field in ("lte", "aov_albedo", "aov_normal"):
            np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{field} spp {s}")
        # the Cornell box has no specular lane, so both count every shadow ray
        assert int(got.n_traces) == int(np.asarray(want.n_traces)), s
        assert got.n_traces.dtype == torch.int64


def _renderer(integrator, engine, size=W, spp=SPP, **kw):
    kw = dict(dict(spp_batch=spp, scene_sky_default=(0.0, 0.0, 0.0)), **kw)
    opt = RenderOption(image_width=size, image_height=size, max_spp=spp, engine=engine,
                       integrator=integrator, mis_mode="ref", **CORNELL_CAM, **kw)
    r = Renderer(option=opt, device="cpu")
    r.set_scene(tscenes.cornell_box_scene())
    return r.build()


@pytest.mark.parametrize("integrator", ["pathtrace", "nee", "mis"])
def test_masked_engine_matches_wavefront_ref(integrator):
    """The same CMJ streams through both engines give the same per-pixel
    means (tests/test_wavefront.py:116); both count the same traces."""
    got = {e: _renderer(integrator, e).render_frame(0) for e in ("masked", "wavefront")}
    for key in ("color", "albedo", "normal"):
        np.testing.assert_allclose(got["masked"][key], got["wavefront"][key], rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    assert got["masked"]["n_traces"] == got["wavefront"]["n_traces"]
    assert "variance" not in got["masked"] and got["masked"]["spp_done"] == SPP


def _rmse_u8(img, golden_name):
    u8 = float_to_srgb_u8(torch.as_tensor(img)).numpy()
    golden = read_png(os.path.join(ROOT, "tests", "golden", golden_name))[..., :3]
    return float(np.sqrt(((u8.astype(np.float32) - golden.astype(np.float32)) ** 2).mean())), u8


def test_golden_headline_masked():
    """tests/test_golden_headline.py:23 on the port: 96x54, 8 spp, MIS,
    thin film, meta-glass, ms-metal and a mesh light (1,444 triangles: the
    binned pack in the sorted wrapper, plain versions on the CPU)."""
    opt = RenderOption(image_width=96, image_height=54, max_spp=8, spp_batch=8,
                       engine="masked", scene_sky_default=(0.15, 0.2, 0.3),
                       camera_position=(0.0, 1.3, 7.5), camera_direction=(0.0, -0.18, -1.0))
    r = Renderer(option=opt, device="cpu").set_scene(tscenes.headline_mini_scene()).build()
    rmse, u8 = _rmse_u8(r.render_frame(0)["color"], "headline_96x54_mis8.png")
    assert rmse < 2.0, f"headline golden mismatch: RMSE {rmse}"
    left = u8[25:40, 8:24].astype(np.float32)  # film_a sphere
    mid = u8[25:40, 32:48].astype(np.float32)  # film_b sphere
    assert np.abs(left - mid).mean() > 2.0, "thin-film sweep collapsed"


def test_golden_cornell_masked():
    """tests/test_render_modes.py:153 on the port: the Cornell box at
    48x48, 16 spp in two batches of 8, MIS."""
    r = _renderer("mis", "masked", size=48, spp=16, spp_batch=8)
    rmse, _ = _rmse_u8(r.render_frame(0)["color"], "cornell_48_mis16.png")
    assert rmse < 2.0, f"golden mismatch: RMSE {rmse}"


def test_masked_checkpoint_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """A masked render killed in its second spp batch resumes from the
    checkpoint and ends with the film of an uninterrupted render; a tile
    smaller than the frame makes each batch several steps, the last one a
    remainder. Both engines write one checkpoint form (with the luminance
    squares and counts), so the wavefront engine resumes it too."""
    monkeypatch.setattr(Renderer, "MASKED_TILE", 96)
    want = _renderer("mis", "masked", spp=2, spp_batch=1).render_frame(0)
    ckpt = str(tmp_path / ".m_000.ckpt.npz")
    r = _renderer("mis", "masked", spp=2, spp_batch=1)
    real = r._make_masked_step
    calls = []

    def dies_in_second_batch(*args):
        step, groups = real(*args)

        def counted(pixel_idx, spp_start, spp_count):
            calls.append(spp_start)
            if len(calls) == 4:
                raise KeyboardInterrupt("killed")
            return step(pixel_idx, spp_start, spp_count)

        return counted, groups

    r._make_masked_step = dies_in_second_batch
    with pytest.raises(KeyboardInterrupt):
        r.render_frame(0, checkpoint_path=ckpt)
    assert calls == [0, 0, 0, 1]  # three tiles of 96, 96 and 64 pixels
    with np.load(ckpt) as ck:
        assert int(ck["spp_done"]) == 1 and (ck["cnt"] == 1).all() and (ck["m2"] > 0).any()
    ckpt_wf = str(tmp_path / ".w_000.ckpt.npz")
    shutil.copy(ckpt, ckpt_wf)
    r2 = _renderer("mis", "masked", spp=2, spp_batch=1)
    got = r2.render_frame(0, checkpoint_path=ckpt)
    assert got["spp_done"] == 2 and 0 < got["n_traces"] < want["n_traces"]
    for key in ("color", "albedo", "normal"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the wavefront engine continues the masked sums (the same streams)
    whole = _renderer("mis", "wavefront", spp=2, spp_batch=1).render_frame(0)
    wf = _renderer("mis", "wavefront", spp=2, spp_batch=1).render_frame(0, checkpoint_path=ckpt_wf)
    assert wf["spp_done"] == 2 and 0 < wf["n_traces"] < whole["n_traces"]
    for key in ("color", "albedo", "normal", "variance", "count"):
        np.testing.assert_allclose(wf[key], whole[key], rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("engine", ["masked", "wavefront"])
def test_deadline_with_a_known_estimate(engine, monkeypatch):
    """An estimate of 1000 s per frame-spp under a 1 s deadline: the
    masked engine's first batch shrinks to 1 spp, the wavefront's (4 spp)
    completes; the next batch stops before its first pixel group."""
    monkeypatch.setattr(Renderer, "MASKED_TILE", 96)
    monkeypatch.setattr(Renderer, "FILM_CHUNK_PIXELS", 96)
    r = _renderer("pathtrace", engine, spp=8, spp_batch=4)
    r._est_px_spp[engine] = 1000.0 / (W * H)
    out = r.render_frame(0, deadline=1.0)
    spp = 1 if engine == "masked" else 4
    assert out["spp_done"] == spp and np.isfinite(out["color"]).all()
    if engine == "wavefront":
        assert (out["count"] == spp).all()


def test_profile_step_rows_at_toy_size():
    """tools/profile_step.py's rows at 16x16 on the CPU (plain versions)."""
    from henjou_torch.tools.profile_step import run_profile_step

    rows = run_profile_step("cpu", lanes=256, reps=1, log=lambda line: None)
    assert len(rows) == 13 and rows["mis_step_traces"] > 256
    assert all(v > 0 for v in rows.values())


@pytest.mark.parametrize("name", ["furnace_scene", "thinfilm_sweep_scene",
                                  "headline_mini_scene"])
def test_testscene_matches_jax(name):
    got, want = getattr(tscenes, name)(), getattr(jscenes, name)()
    for f in ("vertices", "indices", "material_ids", "normals", "texcoords", "colors"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert len(got.materials) == len(want.materials)
    for mg, mw in zip(got.materials, want.materials):
        assert mg.keys() == mw.keys()
        for k in mg:
            np.testing.assert_array_equal(np.asarray(mg[k]), np.asarray(mw[k]), err_msg=k)


def test_furnace_pathtrace_matches_jax():
    """tests/test_pathtrace.py:60 on the port, and against JAX's lanes."""
    n = 2048
    rng = np.random.default_rng(0)
    px = rng.uniform(-0.25, 0.25, size=(n, 2)).astype(np.float32) * 0.8
    o = np.concatenate([px, np.full((n, 1), -3.0, np.float32)], axis=-1)
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    spp, pix = np.arange(n, dtype=np.uint32) % 64, np.arange(n, dtype=np.uint32)
    jf = jsd.build_frame_scene(jsd.build_device_scene(jscenes.furnace_scene(albedo=1.0)))
    tf = tsd.build_frame_scene(tsd.build_device_scene(tscenes.furnace_scene(albedo=1.0), "cpu"))
    jsky = jpay.Sky(constant_color=jnp.ones(3), intensity=jnp.asarray(1.0))
    tsky = tpay.Sky(constant_color=torch.ones(3), intensity=torch.tensor(1.0))
    want = j_pathtrace(jf, jsky, jnp.asarray(o), jnp.asarray(d),
                       j_cmj_state(jnp.asarray(spp), jnp.asarray(pix), 1), jdsp.make_bsdf_sampler(None))
    got = t_pathtrace(tf, tsky, torch.from_numpy(o), torch.from_numpy(d),
                      t_cmj_state(torch.from_numpy(spp.astype(np.int64)),
                                  torch.from_numpy(pix.astype(np.int64)), 1),
                      tdsp.make_bsdf_sampler(None))
    mean = got.lte.numpy().mean(axis=0)
    np.testing.assert_allclose(mean, 1.0, atol=0.03)
    np.testing.assert_allclose(mean, np.asarray(want.lte).mean(axis=0), atol=1e-3)
