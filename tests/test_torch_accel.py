"""Port parity: the bitonic sort's plain version, the sorted wrapper, brute
force and the binned intersector's plain version (the CPU path of both
kernel wrappers) against the JAX package, whose Pallas kernels run in
interpret mode."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from henjou_torch.accel import bitonic as tbit
from henjou_torch.accel import bruteforce as tbf
from henjou_torch.accel import pallas_binned as tpb
from henjou_torch.accel import sorting as tsort
from henjou_torch.runtime import camera as tcam
from henjou_torch.sampling.cmj import make_cmj_state
from henjou_torch.scene.gltf import load_gltf
from henjou_torch.scene.scenedata import build_device_scene, build_frame_scene
from henjou_tpu.accel import bitonic as jbit
from henjou_tpu.accel import bruteforce as jbf
from henjou_tpu.accel import pallas_binned as jpb
from henjou_tpu.accel import sorting as jsort

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

# chip_smoke.py holds the kernels to the same limits
TOL_T_REL = 1e-5
TOL_FLIPS = 1e-4
# against brute force, a different formula (Möller-Trumbore, not the
# Baldwin-Weber plane test): grazing rays lose digits, as in the JAX
# package's own binned-vs-brute-force test (tests/test_pallas_cluster.py)
TOL_T_REL_BRUTEFORCE = 1e-4
# absolute floor on t (scene units; the gallery spans 16): XLA on the CPU
# may contract a*b+c into an FMA where torch does not, so (d - n.o) of
# an origin within a few hundredths of a surface differs by an ulp of d
TOL_T_ABS = 1e-6


@pytest.mark.parametrize("n", [1024, 4096])
def test_bitonic_plain_contract(n):
    """Against bitonic_sort(interpret=True): equal sorted keys, the same
    (key, payload) multiset, and the inverse by lane id restores the input
    exactly (tolerance: none)."""
    rng = np.random.default_rng(n)
    key = rng.integers(0, n // 8, n).astype(np.int32)  # many ties
    pf = rng.standard_normal(n).astype(np.float32)
    pi = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    jk, jf, ji = jbit.bitonic_sort(jnp.asarray(key), jnp.asarray(pf), jnp.asarray(pi), interpret=True)
    lane = torch.arange(n, dtype=torch.int32)
    tk, tf, ti, lid = tbit.bitonic_sort(torch.from_numpy(key), torch.from_numpy(pf),
                                        torch.from_numpy(pi), lane)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())

    def rows(k, f, i):
        r = np.stack([np.asarray(k), np.asarray(f).view(np.int32), np.asarray(i)], 1)
        return r[np.lexsort(r.T[::-1])]

    np.testing.assert_array_equal(rows(jk, jf, ji), rows(tk, tf.numpy(), ti))
    # stable: equal keys keep their input order
    lidn = lid.numpy()
    same = tk.numpy()[1:] == tk.numpy()[:-1]
    assert (lidn[1:][same] > lidn[:-1][same]).all()
    back_f, back_i = tbit.bitonic_unsort(lid, tf, ti)
    assert torch.equal(back_f, torch.from_numpy(pf))
    assert torch.equal(back_i, torch.from_numpy(pi))
    assert tbit.LAUNCHES == 0  # CPU tensors never reach the CUDA kernel


@pytest.mark.parametrize("tile", [512, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("n", [1024, 2048, 4096, 65536, 1 << 18])
def test_plan_passes_cover_the_schedule(n, tile):
    """The network's passes cover every substage of the sort once, in
    order; a local pass is a maximal run of j < tile, a global one at most
    three substages of distinct j >= tile that the next pass could not
    join; the groups of a local pass follow the same rule."""
    subs = tbit.substages(n)
    passes = tbit.plan_passes(subs, tile)
    assert [s for _, first, count in passes for s in range(first, first + count)] == \
        list(range(len(subs)))
    for (kind, first, count), nxt in zip(passes, passes[1:] + (None,)):
        js = [j for _, j in subs[first:first + count]]
        if kind == "local":
            assert max(js) < tile and (nxt is None or nxt[0] == "global")
            groups = tbit.plan_groups(subs, first, count)
            assert [s for f, c in groups for s in range(f, f + c)] == \
                list(range(first, first + count))
            for (f, c), g_next in zip(groups, groups[1:]):
                gj = [j for _, j in subs[f:f + c]]
                assert len(set(gj)) == c <= 3 and (c == 3 or subs[g_next[0]][1] in gj)
        else:
            assert min(js) >= tile and count <= 3 and len(set(js)) == count
            if nxt is not None and nxt[0] == "global" and count < 3:
                assert subs[nxt[1]][1] in js
    if n <= tile:
        assert passes == (("local", 0, len(subs)),)
    if (n, tile) == (65536, 2048):  # 121 substages in 6 local passes, 15 in 7 global
        assert [(kind, count) for kind, _, count in passes if kind == "local"] == \
            [("local", 66)] + [("local", 11)] * 5
        assert [count for kind, _, count in passes if kind == "global"] == [1, 2, 3, 3, 1, 3, 2]


def test_plan_codes_mark_each_pass():
    subs = tbit.substages(8192)
    passes = tbit.plan_passes(subs, 2048, 2)
    codes = tbit.plan_codes(subs, passes, 2)
    assert [(1 << (c & 31), 1 << ((c >> 5) & 31)) for c in codes] == [(j, k) for k, j in subs]
    starts = {first: kind for kind, first, _ in passes}
    groups = {f for _, first, count in passes for f, _ in tbit.plan_groups(subs, first, count, 2)}
    for s, c in enumerate(codes):
        assert bool(c & tbit.PASS_START) == (s in starts)
        assert bool(c & tbit.GLOBAL) == (starts.get(s) == "global")
        assert bool(c & tbit.GROUP_START) == (s in groups)
    codes, count = tbit.c_plan(subs)  # the engine's tile and group size
    assert list(codes) == tbit.plan_codes(subs, tbit.plan_passes(subs, tbit.NETWORK_TILE))
    assert count == len(subs)
    with pytest.raises(ValueError):
        tbit.c_plan(subs * 20)  # more than MAX_SUBS


def test_bitonic_rejects_bad_planes():
    key = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(TypeError):
        tbit.bitonic_sort(key, torch.zeros(1024, dtype=torch.float64))
    with pytest.raises(ValueError):
        tbit.bitonic_sort(key, torch.zeros(512))


def test_ray_sort_key_equal():
    rng = np.random.default_rng(1)
    o = rng.uniform(-5, 5, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    lo = np.asarray([-4.0, -4.0, -4.0], np.float32)
    inv = (1.0 / np.asarray([8.0, 8.0, 8.0])).astype(np.float32)
    a = jsort.ray_sort_key(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo), jnp.asarray(inv))
    b = tsort.ray_sort_key(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(lo),
                           torch.from_numpy(inv))
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@functools.lru_cache(maxsize=None)
def _gallery():
    """(port frame scene, port BinnedClusters, numpy tri_verts, camera rays
    + random rays [2048], JAX BinnedClusters)."""
    tf = build_frame_scene(build_device_scene(load_gltf("scenes/sphere_gallery.gltf"), "cpu"))
    tv = tf.tri_verts.numpy()
    bc = tpb.pack_binned_np(tv, "cpu")
    rng = np.random.default_rng(11)
    cam = tcam.make_camera((0.0, 1.2, -9.0), (0.0, -0.05, 1.0), np.radians(45.0), "cpu")
    pix = torch.from_numpy(rng.integers(0, 512 * 288, 1024))
    o_c, d_c, _ = tcam.camera_rays(cam, 512, 288, pix, make_cmj_state(0, pix, 0))
    o_r = rng.uniform(bc.scene_lo.numpy(), bc.scene_hi.numpy(), (1024, 3)).astype(np.float32)
    d_r = rng.normal(size=(1024, 3)).astype(np.float32)
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    o = torch.cat([o_c, torch.from_numpy(o_r)]).contiguous()
    d = torch.cat([d_c, torch.from_numpy(d_r)]).contiguous()
    return tf, bc, tv, o, d, jpb.pack_binned_np(tv)


def _assert_agree(ref, got, n, closest, t_rel=TOL_T_REL):
    """t within `t_rel` where both hit, hit flips at most TOL_FLIPS of
    the rays, prim equal where t is (ties in t may pick either triangle)."""
    r_t, r_p, _, _, r_h = (np.asarray(x) for x in ref)
    g_t, g_p, _, _, g_h = (x.numpy() for x in got)
    assert (r_h != g_h).sum() <= TOL_FLIPS * n
    both = r_h & g_h
    np.testing.assert_allclose(g_t[both], r_t[both], rtol=t_rel, atol=TOL_T_ABS)
    if closest:
        assert (g_p[both] == r_p[both]).mean() > 0.999
        assert (g_p[~g_h] == -1).all() and np.isinf(g_t[~g_h]).all()


def test_binned_plain_matches_interpret_and_bruteforce_closest():
    _, bc, tv, o, d, jbc = _gallery()
    got = tpb.intersect_binned(bc, o, d, 1e-3)  # CPU tensors: the plain version
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    ref_k = jpb.intersect_binned(jbc, jo, jd, 1e-3, interpret=True)
    ref_b = jbf.intersect_bruteforce(jnp.asarray(tv), jo, jd, 1e-3)
    _assert_agree(ref_k, got, o.shape[0], True)
    _assert_agree(ref_b, got, o.shape[0], True, TOL_T_REL_BRUTEFORCE)
    # against the interpret-mode kernel: prims equal; u, v within 5e-5
    # (an ulp of the hit point, about 5e-7 here, times |g| of the
    # barycentric rows, up to ~30 on the small sphere triangles)
    np.testing.assert_array_equal(np.asarray(ref_k[1]), got[1].numpy())
    for i in (2, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref_k[i]), rtol=0, atol=5e-5)
    assert int(got[4].sum()) > 600
    assert tpb.LAUNCHES == 0


def test_binned_plain_matches_interpret_and_bruteforce_anyhit():
    _, bc, tv, o, d, jbc = _gallery()
    tmax = np.random.default_rng(3).uniform(0.5, 12.0, o.shape[0]).astype(np.float32)
    got = tpb.intersect_binned(bc, o, d, 1e-3, torch.from_numpy(tmax), any_hit=True)
    jo, jd, jt = (jnp.asarray(x) for x in (o.numpy(), d.numpy(), tmax))
    ref_k = jpb.intersect_binned(jbc, jo, jd, 1e-3, jt, any_hit=True, interpret=True)
    ref_b = jbf.occluded_bruteforce(jnp.asarray(tv), jo, jd, 1e-3, jt)
    assert (np.asarray(ref_k[4]) != got[4].numpy()).sum() <= TOL_FLIPS * o.shape[0]
    assert (np.asarray(ref_b) != got[4].numpy()).sum() <= TOL_FLIPS * o.shape[0]
    assert 100 < int(got[4].sum()) < o.shape[0]


def test_bruteforce_port_matches():
    _, _, tv, o, d, _ = _gallery()
    got = tbf.intersect_bruteforce(torch.from_numpy(tv), o[:512], d[:512], 1e-3)
    ref = jbf.intersect_bruteforce(jnp.asarray(tv), jnp.asarray(o[:512].numpy()),
                                   jnp.asarray(d[:512].numpy()), 1e-3)
    _assert_agree(ref, got, 512, True)
    np.testing.assert_array_equal(np.asarray(ref[1]), got[1].numpy())


def test_scene_exit_t_matches():
    _, bc, _, o, d, jbc = _gallery()
    tmin = torch.full((o.shape[0],), 1e-3)
    a = jpb._scene_exit_t(jbc, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(tmin.numpy()))
    b = tpb._scene_exit_t(bc, o, d, tmin)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


@pytest.mark.parametrize("n_rays", [2048, 1500])
def test_sorted_wrapper_is_invisible(n_rays):
    """Sorting around the trace changes nothing per ray, also for a ray
    count that is padded with dead lanes (1500 -> 2048)."""
    _, bc, _, o, d, _ = _gallery()
    o, d = o[:n_rays], d[:n_rays]
    tmax = torch.where(torch.arange(n_rays) % 7 == 0, 0.0, 50.0)  # some dead lanes
    ifn, ofn = tpb.make_binned_intersector(bc)
    sifn, sofn = tsort.make_bitonic_sorted_intersector(ifn, ofn, bc.scene_lo, bc.scene_hi)
    for a, b in zip(ifn(None, o, d, 1e-3, tmax), sifn(None, o, d, 1e-3, tmax)):
        assert torch.equal(a, b)
    tmin = torch.full((n_rays,), 1e-3)
    assert torch.equal(ofn(None, o, d, tmin, tmax), sofn(None, o, d, tmin, tmax))
