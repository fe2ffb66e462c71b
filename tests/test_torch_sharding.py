"""Multi-process spp sharding of the port (runtime/sharding.py and the
sharded frame loop) against one process (tests/test_sharding.py and
tests/test_renderer_multichip.py, whose limits hold here: rtol 3e-5,
atol 1e-6, counts equal).

Two processes (`torch.multiprocessing.spawn`) join a gloo group through a
``file://`` store and run, each on its share:

1. `Renderer.render_frame` on the sphere gallery at 16x16, 8 spp,
   ``spp_batch=1``, on the wavefront engine (4 batches of 2 x 1 spp) and on
   the masked engine (4 spp);
2. the CLI on the gallery option file (rank 0 writes the one PNG);
3. the three helpers: `spp_sharded_step` (masked MIS on the Cornell box,
   one spp per process), `wavefront_sharded_step` and `tile_sharded_step`;
4. a deadline that only rank 0's estimate says is spent: both processes
   stop after the same batch (rank 0 decides; otherwise the all-reduce
   of the next batch would hang);
5. `initialize_and_render` of frames that are not sharded, with the
   checkpoint path that both processes share: the gallery with
   ``adaptive=True`` (4 spp, ``spp_batch=1``), and with
   ``multichip="off"``. Rank 0 renders each alone and is the only process
   that writes its checkpoint; rank 1 renders 0 spp.

The same renders then run in this process without a group. Trace counts
are exact integers and sum exactly.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GALLERY = os.path.join(ROOT, "scenes", "sphere_gallery_option.json")
RTOL, ATOL = 3e-5, 1e-6
WORLD = 2
SPAWN_TIMEOUT_S = 300


def _gallery(engine, spp, **kw):
    from henjou_torch.runtime.renderer import Renderer

    r = Renderer(device="cpu")
    r.load_render_option(GALLERY)
    r.option = dataclasses.replace(r.option, image_width=16, image_height=16, max_spp=spp,
                                   spp_batch=1, engine=engine, mis_mode="ref", **kw)
    r._load_scene_from_option()
    return r


def _cornell_fns():
    """(render_one_spp, wavefront_fn of an spp offset, render_pixels) on the
    Cornell box at 8x8, depth 3."""
    from henjou_torch.bsdf import dispatch as dsp
    from henjou_torch.integrator.mis import mis
    from henjou_torch.integrator.payload import Sky
    from henjou_torch.integrator.wavefront import wavefront_render
    from henjou_torch.runtime.camera import camera_rays, make_camera
    from henjou_torch.sampling.cmj import make_cmj_state
    from henjou_torch.scene import scenedata as sd
    from henjou_torch.scene.testscenes import cornell_box_scene

    frame = sd.build_frame_scene(sd.build_device_scene(cornell_box_scene(), "cpu"))
    sky = Sky(constant_color=torch.zeros(3), intensity=torch.tensor(1.0))
    cam = make_camera((0.0, 0.0, -4.5), (0.0, 0.0, 1.0), np.radians(45.0), "cpu")
    w = h = 8
    bs = dsp.make_bsdf_sampler(None)

    def beval(hit, wo, wi):
        return dsp.bsdf_eval(hit, wo, wi, None)

    def render_pixels(pix, spp_idx):
        st = make_cmj_state(torch.full_like(pix, spp_idx), pix, 7)
        o, d, st = camera_rays(cam, w, h, pix, st)
        res = mis(frame, sky, o, d, st, bs, beval, dsp.bsdf_pdf, max_depth=3)
        return res.lte, res.aov_albedo, res.aov_normal

    def wavefront_fn(spp_offset, spp=1):
        return wavefront_render(frame, sky, cam, w, h, spp, bs, bsdf_eval=beval,
                                bsdf_pdf=dsp.bsdf_pdf, integrator="mis", seed=0, lanes=64,
                                max_depth=3, spp_offset=spp_offset)

    return (lambda s: render_pixels(torch.arange(w * h), s)), wavefront_fn, render_pixels


def _helpers(n_dev):
    """The three helpers' outputs over the current group (or alone)."""
    from henjou_torch.runtime import sharding

    one_spp, wf, pixels = _cornell_fns()
    out = {}
    c, a, nm = sharding.spp_sharded_step(one_spp)(0)
    out.update(spp_color=c.numpy(), spp_albedo=a.numpy())
    c, a, nm, tr, m2, cnt = sharding.wavefront_sharded_step(wf, 1)(0)
    out.update(wf_color=c.numpy(), wf_traces=int(tr), wf_m2=m2.numpy(), wf_count=cnt.numpy())
    c, a, nm = sharding.tile_sharded_step(pixels)(torch.arange(64), 3)
    out.update(tile_color=c.numpy(), tile_normal=nm.numpy())
    return out


def _frame_arrays(prefix, out):
    keys = ("color", "albedo", "normal", "count")
    return {f"{prefix}_{k}": out[k] for k in keys if k in out} | {
        f"{prefix}_traces": out["n_traces"], f"{prefix}_spp": out["spp_done"]}


UNSHARDED = {"adaptive": dict(adaptive=True), "off": dict(multichip="off")}


def _unsharded_frames(rank, out_dir):
    """`initialize_and_render` of each UNSHARDED option in the current
    group: the film rank 0 rendered, this process's frame_stats spp, and
    the checkpoint writes it made (np.savez calls on the checkpoint
    path)."""
    res = {}
    for name, over in UNSHARDED.items():
        r = _gallery("wavefront", 4, image_directory=out_dir, image_name=f"unsharded_{name}",
                     **over)
        films, saves = [], []
        render_frame, savez = r.render_frame, np.savez

        def recorded_render(*a, **kw):
            films.append(render_frame(*a, **kw))
            return films[-1]

        def recorded_savez(path, *a, **kw):
            if ".ckpt.npz" in str(path):
                saves.append(str(path))
            return savez(path, *a, **kw)

        r.render_frame, np.savez = recorded_render, recorded_savez
        try:
            r.initialize_and_render()
        finally:
            np.savez = savez
        res[f"{name}_spp"] = r.frame_stats[0]["spp"]
        res[f"{name}_saves"] = len(saves)
        if films:
            res |= _frame_arrays(name, films[0])
    return res


def _worker(rank, store, out_dir):
    import torch.distributed as dist

    from henjou_torch import render
    from henjou_torch.runtime import sharding

    torch.set_num_threads(1)
    os.chdir(ROOT)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=WORLD, rank=rank)
    try:
        assert sharding.world() == (WORLD, rank)
        res = _frame_arrays("wave", _gallery("wavefront", 8).render_frame(0))
        res |= _frame_arrays("masked", _gallery("masked", 4).render_frame(0))
        res |= _helpers(WORLD)
        render.main([GALLERY, "--device", "cpu", "--size", "16x16", "--spp", "4",
                     "--out", os.path.join(out_dir, "cli_sharded")])
        # only rank 0's estimate says a batch costs more than the deadline
        r = _gallery("wavefront", 8)
        r._est_px_spp["wavefront"] = 1e6 if rank == 0 else 1e-12
        res["deadline_spp"] = r.render_frame(0, deadline=1000.0)["spp_done"]
        res |= _unsharded_frames(rank, out_dir)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    import torch.multiprocessing as mp

    out = tmp_path_factory.mktemp("sharded")
    ctx = mp.spawn(_worker, args=(str(out / "store"), str(out)), nprocs=WORLD, join=False)
    t_end = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > t_end:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"sharded workers still running after {SPAWN_TIMEOUT_S} s")
    return out, [dict(np.load(out / f"rank{k}.npz")) for k in range(WORLD)]


def _check_frame(got, want, prefix):
    for k in ("color", "albedo", "normal"):
        np.testing.assert_allclose(got[f"{prefix}_{k}"], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert int(got[f"{prefix}_traces"]) == want["n_traces"]
    assert int(got[f"{prefix}_spp"]) == want["spp_done"]


def test_sharded_wavefront_frame_matches_one_process(sharded):
    _, ranks = sharded
    want = _gallery("wavefront", 8).render_frame(0)
    assert want["spp_done"] == 8 and (want["count"] == 8).all()
    for got in ranks:  # every process holds the whole film
        _check_frame(got, want, "wave")
        assert np.array_equal(got["wave_count"], want["count"])


def test_sharded_masked_frame_matches_one_process(sharded):
    _, ranks = sharded
    want = _gallery("masked", 4).render_frame(0)
    for got in ranks:
        _check_frame(got, want, "masked")


def test_sharded_cli_writes_one_png(sharded, tmp_path, monkeypatch):
    from henjou_torch import render
    from henjou_torch.post.png import read_png

    out_dir, _ = sharded
    monkeypatch.chdir(ROOT)
    assert render.main([GALLERY, "--device", "cpu", "--size", "16x16", "--spp", "4",
                        "--out", str(tmp_path / "cli_one")]) == 0
    got = read_png(str(out_dir / "cli_sharded_000.png")).astype(np.int32)
    want = read_png(str(tmp_path / "cli_one_000.png")).astype(np.int32)
    # 8-bit sRGB of films within rtol 3e-5: a value may round the other way
    assert np.abs(got - want).max() <= 1
    assert sorted(p.name for p in out_dir.glob("cli_sharded*")) == ["cli_sharded_000.png"]


@pytest.mark.parametrize("which", ["spp", "wavefront", "tile"])
def test_sharded_helpers_match_one_process(sharded, which):
    _, ranks = sharded
    want = _helpers(1)
    if which == "spp":
        # the mean of one spp per process equals the mean of those spp here
        one_spp, _, _ = _cornell_fns()
        c = sum(one_spp(k)[0] for k in range(WORLD)) / WORLD
        a = sum(one_spp(k)[1] for k in range(WORLD)) / WORLD
        for got in ranks:
            np.testing.assert_allclose(got["spp_color"], c.numpy(), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got["spp_albedo"], a.numpy(), rtol=RTOL, atol=ATOL)
    elif which == "wavefront":
        ref = _cornell_fns()[1](0, spp=WORLD)  # both slices in one pool
        for got in ranks:
            np.testing.assert_allclose(got["wf_color"], ref.color.numpy(), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got["wf_m2"], ref.m2.numpy(), rtol=RTOL, atol=ATOL)
            assert np.array_equal(got["wf_count"], ref.count.numpy())
            assert int(got["wf_traces"]) == int(ref.n_traces)
    else:
        for got in ranks:
            assert np.array_equal(got["tile_color"], want["tile_color"])
            assert np.array_equal(got["tile_normal"], want["tile_normal"])


def test_rank0_decides_the_deadline(sharded):
    """Rank 0's estimate stops the frame after its first batch; rank 1's
    own estimate would go on, but it follows rank 0 (4 spp would hang)."""
    _, ranks = sharded
    assert [int(r["deadline_spp"]) for r in ranks] == [WORLD, WORLD]


@pytest.mark.parametrize("name", sorted(UNSHARDED))
def test_unsharded_frame_renders_once_on_rank0(sharded, name):
    """A frame that is not sharded (adaptive allocation, or multichip
    "off") inside a group: rank 0 renders it alone and writes its
    checkpoint once per spp batch, rank 1 renders 0 spp and writes none,
    no checkpoint is left, and rank 0's film equals one process's."""
    out_dir, (r0, r1) = sharded
    assert int(r1[f"{name}_spp"]) == 0 and f"{name}_color" not in r1
    assert int(r1[f"{name}_saves"]) == 0
    assert int(r0[f"{name}_saves"]) == 4  # spp_batch 1, 4 spp
    assert not list(out_dir.glob(f".unsharded_{name}_*"))
    assert sorted(p.name for p in out_dir.glob(f"unsharded_{name}*")) == [
        f"unsharded_{name}_000.png"]
    want = _gallery("wavefront", 4, **UNSHARDED[name]).render_frame(0)
    _check_frame(r0, want, name)
    assert np.array_equal(r0[f"{name}_count"], want["count"])
    assert int(r0[f"{name}_spp"]) == 4
