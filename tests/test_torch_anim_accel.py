"""Animated geometry: the cluster order planned once, the pack refreshed per
frame on the device (port of tests/test_twolevel_accel.py).

- `plan_binned_order` bit-equal to the JAX package's;
- `build_binned_from_order`: `aabb`, `gaabb` and the scene box equal to
  the JAX refresh (min/max of gathered values: exact), row 12 (the order)
  bit-equal, and rows 0-11 within ROW_ULPS ulps of each value's scale (the
  magnitude of the terms it is computed from: |e1||e2| for the normal n,
  |n||v0| for d; g1 and g2 scale as |e2|/|n| and |e1|/|n| times the
  triangle's condition |e1||e2|/|n|, by which n's relative error grows,
  and h as that times |v0|), since XLA may contract the cross and dot
  products into FMAs; against the port's own host pack, every row
  bit-equal;
- the plain binned intersector on a refreshed pack after a rigid move
  equal to brute force (tests/test_twolevel_accel.py:30, :46);
- three animated frames run pack_binned_np at most once (:64), on the CPU
  as on CUDA; an unchanged transform set reuses its accel, a static
  scene never plans an order, and a scene of 256 triangles or fewer
  never packs.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import henjou_torch.accel.pallas_binned as tpb
import henjou_tpu.accel.pallas_binned as jpb
from henjou_torch.accel.bruteforce import intersect_bruteforce
from henjou_torch.runtime.options import RenderOption
from henjou_torch.runtime.renderer import Renderer
from henjou_torch.scene import animation, testscenes
from henjou_torch.scene.scenedata import SceneData, make_material

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

ROW_ULPS = 64
CASES = {
    "700 in two ranges": (700, [(0, 300), (300, 400)]),
    "20000 in three ranges": (20000, [(0, 5000), (5000, 14000), (14000, 1000)]),
    "90000, grouped": (90000, None),
}


@functools.lru_cache(maxsize=None)
def _tris(t, seed=3):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-4.0, 4.0, (t, 1, 3))
    return (c + rng.normal(scale=0.3, size=(t, 3, 3))).astype(np.float32)


def _planes(rows):
    """[Ctot*16, K] rows -> [Ctot*K, 16] per triangle."""
    return rows.reshape(-1, 16, tpb.K).transpose(0, 2, 1).reshape(-1, 16)


def _row_scale(tv, order):
    """Each row value's scale (see the module docstring), in float64."""
    v = np.where((order >= 0)[:, None, None], tv[np.maximum(order, 0)], 0.0).astype(np.float64)
    e1, e2, v0 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], v[:, 0]
    n = np.cross(e1, e2)
    ln = np.maximum(np.linalg.norm(n, axis=1), 1e-30)
    nn = np.where(ln > 1e-30, ln * ln, 1.0)[:, None]
    g1, g2 = np.cross(e2, n) / nn, np.cross(n, e1) / nn

    def norm(x):
        return np.linalg.norm(x, axis=1)

    # n's relative error is up to cond = |e1||e2| / |n| ulps, which g takes
    cond = norm(e1) * norm(e2) / ln
    s1, s2 = norm(e2) / ln * cond, norm(e1) / ln * cond
    cols = ([norm(e1) * norm(e2)] * 3 + [ln * norm(v0)] + [s1] * 3 + [s1 * norm(v0)]
            + [s2] * 3 + [s2 * norm(v0)])
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("case", list(CASES))
def test_plan_and_refresh_match_jax(case):
    t, ranges = CASES[case]
    tv = _tris(t)
    want_plan = jpb.plan_binned_order(tv, ranges)
    plan = tpb.plan_binned_order(tv, ranges)
    assert plan[0].dtype == np.int32 and np.array_equal(plan[0], want_plan[0])
    assert plan[1:] == tuple(want_plan[1:])
    order = plan[0]
    want = jpb.build_binned_from_order(jnp.asarray(tv), jnp.asarray(order), *plan[1:])
    got = tpb.build_binned_from_order(torch.from_numpy(tv), order, *plan[1:])
    for f in ("aabb", "gaabb", "scene_lo", "scene_hi"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    assert (got.num_clusters, got.group, got.num_groups) == tuple(plan[1:])
    g_rows, w_rows = _planes(got.rows.numpy()), _planes(np.asarray(want.rows))
    assert np.array_equal(g_rows[:, 12].view(np.int32), order)
    assert np.array_equal(w_rows[:, 12].view(np.int32), order)
    tol = ROW_ULPS * np.finfo(np.float32).eps * _row_scale(tv, order)
    assert (np.abs(g_rows[:, :12].astype(np.float64) - w_rows[:, :12]) <= tol).all()
    assert not g_rows[:, 13:].any()


def test_refresh_of_one_range_equals_host_pack():
    """With the whole scene as one range the refresh is the host pack,
    every plane bit-equal (the same operations in the same order)."""
    tv = _tris(3000)
    order, *rest = tpb.plan_binned_order(tv)
    got = tpb.build_binned_from_order(torch.from_numpy(tv), torch.from_numpy(order), *rest)
    want = tpb.pack_binned_np(tv, "cpu")
    for f in ("rows", "aabb", "gaabb", "scene_lo", "scene_hi"):
        assert torch.equal(getattr(got, f).view(torch.int32), getattr(want, f).view(torch.int32)), f


def _rays(rng, n):
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("moved", [False, True], ids=["rest", "rigid move"])
def test_refreshed_pack_hits_match_bruteforce(moved):
    """Two ranges planned at rest; the second moved rigidly and the pack
    refreshed from the same order: hits, t and prims equal brute force."""
    rng = np.random.default_rng(5)
    tris = _tris(700, seed=5)
    order, *rest = tpb.plan_binned_order(tris, [(0, 300), (300, 400)])
    if moved:
        tris = tris.copy()
        tris[300:] += np.asarray([2.5, -1.0, 0.5], np.float32)
    tv = torch.from_numpy(tris)
    bc = tpb.build_binned_from_order(tv, order, *rest)
    o, d = _rays(rng, 1024)
    t_b, p_b, _, _, h_b = intersect_bruteforce(tv, o, d, 1e-3)
    t_p, p_p, _, _, h_p = tpb.intersect_binned(bc, o, d, 1e-3)
    assert torch.equal(h_b, h_p) and int(h_b.sum()) > 100
    np.testing.assert_allclose(t_p[h_b].numpy(), t_b[h_b].numpy(), rtol=1e-4)
    assert torch.equal(p_p[h_b].long(), p_b[h_b].long())


def _animated_gallery():
    """The gallery with every instance on a keyframed translation."""
    scene = testscenes.sphere_gallery_scene()
    a = animation.static_animation((0, 0, 0), (0, 0, 0, 1), (1, 1, 1))
    a.translation.keys = [0.0, 1.0]
    a.translation.values = [[0, 0, 0], [0.5, 0, 0]]
    scene.animations.append(a)
    for inst in scene.instances:
        inst.animation_id = len(scene.animations) - 1
    return scene


def _counting(monkeypatch):
    calls = {"pack": 0, "refresh": 0}
    for name, key in (("pack_binned_np", "pack"), ("build_binned_from_order", "refresh")):
        real = getattr(tpb, name)

        def counted(*args, real=real, key=key, **kw):
            calls[key] += 1
            return real(*args, **kw)

        monkeypatch.setattr(tpb, name, counted)
    return calls


def test_animated_frames_pack_on_the_host_at_most_once(monkeypatch):
    calls = _counting(monkeypatch)
    opt = RenderOption(image_width=32, image_height=32, max_spp=2, spp_batch=2,
                       end_frame=3, engine="masked")
    r = Renderer(option=opt, integrator="pathtrace", device="cpu")
    r.set_scene(_animated_gallery()).build()
    imgs = [r.render_frame(f) for f in range(3)]
    # frame 0 packs on the host; frame 1 plans and refreshes; frame 2
    # refreshes
    assert calls == {"pack": 1, "refresh": 2}, calls
    for out in imgs:
        assert np.isfinite(out["color"]).all() and out["n_traces"] > 0
    # the refreshed pack follows the motion: frame 2's box is frame 0's
    # moved by the keyframed translation at 2/24 s
    shift = 0.5 * 2 / r.option.fps
    lo0 = r.frame_scene(0)[1].scene_lo
    np.testing.assert_allclose(r.frame_scene(2)[1].scene_lo[0] - lo0[0], shift, atol=1e-5)


def _soup(n):
    """A static scene of n random triangles."""
    tv = _tris(n).reshape(-1, 3)
    return SceneData(vertices=tv, indices=np.arange(len(tv)), material_ids=np.zeros(n),
                     normals=None, texcoords=None, colors=None,
                     materials=[make_material("grey")])


@pytest.mark.parametrize("static, packs", [("gallery", 1), (256, 0), (257, 1)],
                         ids=["gallery", "256 tris", "257 tris"])
def test_accel_reused_until_the_transforms_change(monkeypatch, static, packs):
    """A transform set seen last reuses its accel; a static scene packs
    once and never plans an order, unless it has BRUTE_FORCE_MAX_TRIS
    (256) triangles or fewer: then it traces by brute force (accel None)
    and never packs."""
    calls = _counting(monkeypatch)
    r = Renderer(option=RenderOption(end_frame=3), device="cpu")
    r.set_scene(_animated_gallery()).build()
    for f in (0, 1, 2, 2):
        r.frame_scene(f)
    assert calls == {"pack": 1, "refresh": 2}, calls
    calls.update(pack=0, refresh=0)
    r = Renderer(option=RenderOption(end_frame=3), device="cpu")
    r.set_scene(testscenes.sphere_gallery_scene() if static == "gallery" else _soup(static))
    r.build()
    accels = [r.frame_scene(f)[1] for f in (0, 1, 2)]
    assert calls == {"pack": packs, "refresh": 0} and r.scene_accel.plan is None, calls
    assert all((a is None) == (packs == 0) for a in accels)
