"""The port's render modes as a whole, on the CPU.

Two frames of an animated camera are rendered by the port on the Cornell
box (brute-force probes) and on the sphere gallery (over 256 triangles, so
the probes trace through the binned intersector). The same AOV dicts go
through `_finalize` of a JAX `Renderer` and of the port's `Renderer`, built
on the same scene and options, in Denoise, DenoiseUpScale2X and
DenoiseTemporal, frames 0 then 1. Limit: rtol 1e-4, atol 1e-5 per value;
at most 1e-3 of the pixels may exceed it, and only where the two probes'
first hits differ (a tie or an is_hit flip between the packages'
intersectors).

Then: Debug mode against the JAX `render_debug`; the mode cases of
tests/test_render_modes.py on the port; the firefly clamp's auto mode;
checkpoint/resume; the CLI on the shipped contest option file."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from henjou_torch import render
from henjou_torch.post.png import read_png
from henjou_torch.runtime.options import RenderMode, RenderOption
from henjou_torch.runtime.renderer import Renderer

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
# share of the pixels allowed beyond the limit, each at a probe mismatch
PROBE_SHARE = 1e-3

VIEWS = {
    "cornell": dict(camera_position=(0.0, 0.0, -4.5), camera_direction=(0.0, 0.0, 1.0),
                    scene_sky_default=(0.0, 0.0, 0.0)),
    "gallery": dict(camera_position=(0.0, 1.2, -9.0), camera_direction=(0.0, -0.05, 1.0),
                    scene_sky_default=(0.3, 0.4, 0.55), camera_fov=math.radians(45.0)),
}
# every Denoise mode's AOVs are 16x16 (UpScale2X renders at half its
# 32x32), so each JAX filter compiles for one shape
SIZES = {RenderMode.DENOISE: 16, RenderMode.DENOISE_TEMPORAL: 16,
         RenderMode.DENOISE_UPSCALE2X: 32}


def _animate(scene, anim_mod):
    """A quarter turn about Y and a 2-unit truck over one second
    (tests/test_render_modes.py's camera animation): frame 1 at 24 fps
    moves the camera by 3.75 degrees."""
    anim = anim_mod.Animation()
    anim.translation = anim_mod.AnimationTrack(keys=[0.0, 1.0], values=[[0, 0, 0], [2, 0, 0]])
    anim.rotation = anim_mod.AnimationTrack(keys=[0.0, 1.0],
                                            values=[[0, 0, 0, 1], [0, 0.7071068, 0, 0.7071068]])
    scene.animations = [anim]
    scene.camera_animation_id = 0
    return scene


def _option_kw(view, mode, spp):
    size = SIZES.get(mode, 16)
    return dict(image_width=size, image_height=size, max_spp=spp, spp_batch=spp,
                render_mode=mode, allow_camera_animation=True, **VIEWS[view])


def _port(view, mode=RenderMode.DEFAULT, spp=2, **kw):
    from henjou_torch.scene import animation, testscenes

    scene = (testscenes.cornell_box_scene() if view == "cornell"
             else testscenes.sphere_gallery_scene())
    r = Renderer(option=RenderOption(**{**_option_kw(view, mode, spp), **kw}), device="cpu")
    r.set_scene(_animate(scene, animation))
    return r.build()


def _jax(view, mode, port):
    """The JAX Renderer on the same scene and options. Its probes take the
    accel of its `_accel_cache`; the port's binned pack is pinned there (on
    the CPU the JAX package would pick an LBVH), so both trace the same
    clusters, the JAX kernel in interpret mode."""
    from henjou_tpu.accel.pallas_binned import pack_binned_np
    from henjou_tpu.runtime.options import RenderMode as JMode
    from henjou_tpu.runtime.options import RenderOption as JOption
    from henjou_tpu.runtime.renderer import Renderer as JRenderer
    from henjou_tpu.scene import animation, testscenes

    scene = (testscenes.cornell_box_scene() if view == "cornell"
             else testscenes.sphere_gallery_scene())
    kw = _option_kw(view, mode, port.option.max_spp)
    r = JRenderer(option=JOption(**dict(kw, render_mode=JMode(mode.value))))
    r.set_scene(_animate(scene, animation))
    r.build()
    fs = r._frame_build(r.device_scene, *r._frame_transforms(0.0))
    n = int(fs.tri_verts.shape[0])
    r._accel_cache = (None, pack_binned_np(np.asarray(fs.tri_verts)) if n > 256 else None)
    return r


def _probe_mismatch(port, jr, mode, frame, width, height):
    """[H,W] True where the two packages' first-hit probes of `mode` (the
    depth probe of DenoiseTemporal, the guide probe of DenoiseUpScale2X,
    each as `_finalize` calls it) disagree: an is_hit flip, or a position,
    albedo or normal that differs beyond 1e-4 (another triangle hit)."""
    from henjou_torch.runtime import renderer as trm
    from henjou_tpu.runtime import renderer as jrm

    if mode == RenderMode.DENOISE:
        return np.zeros((height, width), bool)
    fs, accel, cam = port.frame_scene(frame)
    time_s = frame / float(jr.option.fps)
    jargs = (jr._frame_build(jr.device_scene, *jr._frame_transforms(time_s)), jr.sky,
             jr._frame_camera(time_s), jr._accel_cache[1], width, height)
    probe = "_temporal_depth_probe" if mode == RenderMode.DENOISE_TEMPORAL else "_guide_probe"
    got = getattr(trm, probe)(fs, port.sky, cam, accel, width, height)
    want = getattr(jrm, probe)(*jargs)
    bad = np.zeros((height, width), bool)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype == bool:
            bad |= g != w
        else:
            bad |= ~np.isclose(g, w, rtol=1e-4, atol=1e-4).all(-1)
    return bad


def _on_cpu(aovs):
    """The image AOVs as the float32 tensors `_finalize` hands its filters."""
    return {k: torch.as_tensor(aovs[k], dtype=torch.float32) if k in aovs else None
            for k in ("color", "albedo", "normal", "variance", "count")}


def _compare(got, want, mismatch):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    n_bad = int(bad.sum())
    assert n_bad <= PROBE_SHARE * bad.size, (
        f"{n_bad} of {bad.size} pixels beyond the limit, max diff "
        f"{np.abs(got - want).max():.3g}")
    assert not (bad & ~mismatch).any(), "a pixel differs where the probes agree"


@pytest.fixture(scope="module")
def port_aovs():
    """Two frames of each view rendered once by the port, at the 16x16 film
    every Denoise mode finalizes."""
    out = {}
    for view in VIEWS:
        r = _port(view, RenderMode.DENOISE_TEMPORAL)
        out[view] = [r.render_frame(f) for f in (0, 1)]
    return out


@pytest.mark.parametrize("mode", [RenderMode.DENOISE, RenderMode.DENOISE_UPSCALE2X,
                                  RenderMode.DENOISE_TEMPORAL], ids=lambda m: m.value)
@pytest.mark.parametrize("view", list(VIEWS))
def test_finalize_matches_jax(port_aovs, view, mode):
    port = _port(view, mode)
    jr = _jax(view, mode, port)
    size = port.option.image_width
    for frame, aovs in enumerate(port_aovs[view]):
        got = port._finalize(dict(aovs), frame=frame)
        want = jr._finalize(dict(aovs), frame=frame)
        assert got.shape == (size, size, 3)
        _compare(got, want, _probe_mismatch(port, jr, mode, frame, size, size))
    if mode == RenderMode.DENOISE_TEMPORAL:
        # frame 1 took the pre-filter accumulation: history was banked
        # and merged with a real reprojection (the camera moved)
        assert port._temporal_prev_frame == 1 and port._temporal_raw is not None
        assert float(port._temporal_raw[2].max()) > float(port_aovs[view][1]["count"].max())
        assert not torch.equal(port._temporal_prev_cam.position,
                               port.frame_scene(0)[2].position)


@pytest.mark.parametrize("branch", ["reprojected", "blend"])
@pytest.mark.parametrize("view", list(VIEWS))
def test_finalize_temporal_other_branches_match_jax(port_aovs, view, branch):
    """The two DenoiseTemporal branches the wavefront film does not take,
    against the JAX package on the same AOVs: without the variance and
    count AOVs the reprojected previous output is blended
    (`denoise_temporal_reprojected` after `denoise_atrous`); without a
    device scene there is no depth probe, and the unwarped previous output
    is blended (`denoise_temporal`)."""
    mode = RenderMode.DENOISE_TEMPORAL
    port = _port(view, mode)
    jr = _jax(view, mode, port)
    frames = [{k: v for k, v in a.items() if k not in ("variance", "count")}
              for a in port_aovs[view]]
    if branch == "blend":
        port.device_scene = jr.device_scene = None
    for frame, aovs in enumerate(frames):
        got = port._finalize(dict(aovs), frame=frame)
        want = jr._finalize(dict(aovs), frame=frame)
        mismatch = (_probe_mismatch(_port(view, mode), _jax(view, mode, port), mode, frame, 16, 16)
                    if branch == "reprojected" else np.zeros((16, 16), bool))
        _compare(got, want, mismatch)
    assert port._temporal_raw is None
    assert (port._temporal_prev_cam is None) == (branch == "blend")


def test_finalize_temporal_restarts_on_a_frame_gap(port_aovs):
    """History is used only for the frame right after the previous one:
    frame 0 then frame 2 gives frame 2 the spatial filter alone."""
    port = _port("cornell", RenderMode.DENOISE_TEMPORAL)
    a0, a1 = port_aovs["cornell"]
    port._finalize(dict(a0), frame=0)
    gap = port._finalize(dict(a1), frame=2)
    np.testing.assert_array_equal(gap, port._spatial_denoise(_on_cpu(a1)).numpy())
    assert port._temporal_raw[2].max() == float(a1["count"].max())


@pytest.mark.parametrize("view", list(VIEWS))
def test_render_debug_matches_jax(view):
    port = _port(view, RenderMode.DEBUG, spp=1)
    jr = _jax(view, RenderMode.DEBUG, port)
    for frame in (0, 1):
        got = port.render_debug(frame)
        want = jr.render_debug(frame)
        hit_p = np.abs(got["normal"]).sum(-1) > 0
        hit_j = np.abs(want["normal"]).sum(-1) > 0
        flips = hit_p != hit_j
        assert flips.sum() <= PROBE_SHARE * flips.size
        for key in ("position", "basecolor", "normal", "texcoord"):
            assert got[key].shape == want[key].shape
            ok = np.isclose(got[key], np.asarray(want[key]), rtol=RTOL, atol=1e-4).all(-1)
            assert (ok | flips).all(), key


# ---------------- the mode cases of tests/test_render_modes.py ----------------


def test_denoise_mode_reduces_variance(tmp_path):
    r = _port("cornell", RenderMode.DENOISE, spp=8, image_directory=str(tmp_path),
              image_name="dn", allow_camera_animation=False)
    r.option = dataclasses.replace(r.option, image_width=32, image_height=32)
    aovs = r.render_frame(0)
    noisy = aovs["color"]
    out = r._finalize(aovs)
    assert out.shape == noisy.shape and np.isfinite(out).all()
    assert np.var(out[8:-8, 8:-8]) < np.var(noisy[8:-8, 8:-8])


def test_upscale2x_mode_doubles_resolution(tmp_path):
    r = _port("cornell", RenderMode.DENOISE_UPSCALE2X, spp=4, image_directory=str(tmp_path),
              image_name="up")
    written = r.initialize_and_render()
    assert read_png(written[0]).shape[:2] == (32, 32)
    assert r.frame_stats[0]["finalize_s"] > 0 and r.frame_stats[0]["image_finite"]


def _jax_masked_frames(size=32, spp=4):
    """Two frames of the static Cornell box from the JAX package's CPU
    engine (the masked one: AOVs without variance and count), exactly the
    renders of tests/test_render_modes.py's flicker case."""
    from henjou_tpu.runtime.options import RenderMode as JMode
    from henjou_tpu.runtime.options import RenderOption as JOption
    from henjou_tpu.runtime.renderer import Renderer as JRenderer
    from henjou_tpu.scene.testscenes import cornell_box_scene

    jr = JRenderer(option=JOption(image_width=size, image_height=size, max_spp=spp,
                                  spp_batch=spp, render_mode=JMode.DENOISE_TEMPORAL,
                                  **VIEWS["cornell"]))
    jr.set_scene(cornell_box_scene())
    jr.build()
    return [{k: np.asarray(v) if k in ("color", "albedo", "normal") else v
             for k, v in jr.render_frame(f).items()} for f in (0, 1)]


def test_temporal_mode_reduces_flicker(tmp_path):
    """Two frames of a static scene with different sample sets: the
    temporal output flickers less than independently denoised frames.
    On the JAX case's own films (no variance AOV: `_finalize` blends the
    reprojected previous output) at its limit, 0.6 of denoise_atrous's
    flicker; on the port's wavefront films (the raw history merged before
    the SVGF filter, which takes less history at 4 spp) below the
    flicker of independently SVGF-filtered frames."""
    from henjou_torch.post.denoise import denoise_atrous

    for film in ("masked", "wavefront"):
        r = _port("cornell", RenderMode.DENOISE_TEMPORAL, spp=4, image_directory=str(tmp_path),
                  image_name="tmp", allow_camera_animation=False)
        r.option = dataclasses.replace(r.option, image_width=32, image_height=32)
        if film == "masked":
            aovs = _jax_masked_frames()
            assert "variance" not in aovs[0]
            ind = [denoise_atrous(*(torch.from_numpy(a[k]) for k in ("color", "albedo", "normal")))
                   .numpy() for a in aovs]
            limit = 0.6
        else:
            aovs = [r.render_frame(0), r.render_frame(1)]
            ind = [r._spatial_denoise(_on_cpu(a)).numpy() for a in aovs]
            limit = 1.0
        out0 = r._finalize(aovs[0], frame=0)
        out1 = r._finalize(aovs[1], frame=1)
        assert np.isfinite(out1).all()
        temporal, independent = np.abs(out1 - out0).mean(), np.abs(ind[1] - ind[0]).mean()
        assert temporal < independent * limit, (film, temporal, independent)


def test_debug_mode_outputs_four_aovs(tmp_path):
    r = _port("cornell", RenderMode.DEBUG, spp=1, image_directory=str(tmp_path),
              image_name="dbg")
    written = r.initialize_and_render()
    names = [os.path.basename(w) for w in written]
    for key in ("position", "basecolor", "normal", "texcoord"):
        assert any(key in n for n in names), names
    assert all(read_png(w).shape == (16, 16, 3) for w in written)


# ---------------- firefly clamp, checkpoint/resume, CLI ----------------


@pytest.mark.parametrize("mode,clamp", [
    (RenderMode.DEFAULT, 0.0), (RenderMode.DEBUG, 0.0), (RenderMode.DENOISE, 64.0),
    (RenderMode.DENOISE_UPSCALE2X, 64.0), (RenderMode.DENOISE_TEMPORAL, 64.0),
], ids=lambda v: getattr(v, "value", v))
def test_firefly_clamp_auto(monkeypatch, mode, clamp):
    """Auto (-1) is 64.0 in the three Denoise modes and off otherwise; an
    explicit value passes through. Captured where it reaches the engine."""
    from henjou_torch.integrator import wavefront

    seen = []
    real = wavefront.wavefront_render

    def spy(*args, **kw):
        seen.append(kw["firefly_clamp"])
        return real(*args, **kw)

    monkeypatch.setattr(wavefront, "wavefront_render", spy)
    r = _port("cornell", mode, spp=1)
    r.render_frame(0)
    r.option = dataclasses.replace(r.option, firefly_clamp=3.0)
    r.render_frame(0)
    assert seen == [clamp, 3.0]


def test_checkpoint_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """A render killed after its first spp batch resumes from the
    checkpoint and ends with the film of an uninterrupted render."""
    from henjou_torch.integrator import wavefront

    whole = _port("gallery", spp=2)
    whole.option = dataclasses.replace(whole.option, spp_batch=1)
    want = whole.render_frame(0)

    ckpt = str(tmp_path / ".g_000.ckpt.npz")
    real = wavefront.wavefront_render
    calls = []

    def dies_on_second_batch(*args, **kw):
        calls.append(kw["spp_offset"])
        if len(calls) == 2:
            raise KeyboardInterrupt("killed")
        return real(*args, **kw)

    r = _port("gallery", spp=2)
    r.option = dataclasses.replace(r.option, spp_batch=1)
    monkeypatch.setattr(wavefront, "wavefront_render", dies_on_second_batch)
    with pytest.raises(KeyboardInterrupt):
        r.render_frame(0, checkpoint_path=ckpt)
    with np.load(ckpt) as ck:
        assert int(ck["spp_done"]) == 1 and int(ck["frame"]) == 0
    monkeypatch.setattr(wavefront, "wavefront_render", real)
    r2 = _port("gallery", spp=2)
    r2.option = dataclasses.replace(r2.option, spp_batch=1)
    got = r2.render_frame(0, checkpoint_path=ckpt)
    assert got["spp_done"] == 2 and got["n_traces"] < want["n_traces"]
    for key in ("color", "albedo", "normal", "variance", "count"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # a checkpoint of another frame is ignored, then replaced
    other = r2.render_frame(1, checkpoint_path=ckpt)
    assert other["spp_done"] == 2 and other["n_traces"] > 0
    with np.load(ckpt) as ck:
        assert int(ck["frame"]) == 1 and int(ck["spp_done"]) == 2
    # so is one without the film's second moments and counts
    with np.load(ckpt) as ck:
        np.savez(ckpt, **{k: ck[k] for k in ck.files if k not in ("m2", "cnt")})
    again = r2.render_frame(1, checkpoint_path=ckpt)
    assert again["spp_done"] == 2 and again["n_traces"] == other["n_traces"]


def test_initialize_and_render_removes_checkpoints(tmp_path):
    r = _port("cornell", RenderMode.DENOISE_TEMPORAL, spp=1, image_directory=str(tmp_path),
              image_name="anim", end_frame=2)
    written = r.initialize_and_render()
    assert [os.path.basename(w) for w in written] == ["anim_000.png", "anim_001.png"]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".ckpt.npz")]


def test_cli_contest_option_as_shipped(tmp_path, monkeypatch):
    """scenes/rtcamp_720_option.json as shipped (DenoiseTemporal, two
    frames) through the CLI at a toy size: two PNGs, the finalize timed."""
    monkeypatch.chdir(ROOT)
    out = str(tmp_path / "rtcamp720")
    stats = str(tmp_path / "stats.json")
    assert render.main([os.path.join("scenes", "rtcamp_720_option.json"), "--device", "cpu",
                        "--size", "32x18", "--spp", "1", "--out", out, "--stats", stats]) == 0
    for f in (0, 1):
        assert read_png(f"{out}_{f:03d}.png").shape == (18, 32, 3)
    with open(stats) as fh:
        frames = json.load(fh)["frames"]
    assert [fr["spp"] for fr in frames] == [1, 1]
    assert all(fr["finalize_s"] > 0 and fr["image_finite"] for fr in frames)
