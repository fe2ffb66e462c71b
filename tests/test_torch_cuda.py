"""The CUDA kernels against their plain versions, on the card: 243 cases,
52 of them the cluster walk of the binned, flat, two-level and
matrix-form kernels, 7 the denoiser's tensor ops on CUDA against the CPU,
2 the sorted binned trace at the masked engine's 131,072-ray tile, 1
the animated pack's refresh on CUDA against the CPU, 1 the Sobol draws
on CUDA against the CPU, 1 the pool re-sort's 27-column sort, and 84
the CMJ draw kernel against the torch code on the same CUDA state.

These need an NVIDIA GPU and nvcc; without them they skip. The tests
directory's conftest imports jax, which the GPU machine may not have, so
run them there without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

chip_smoke.py runs the same checks at the renderer's full shapes."""

import numpy as np
import pytest
import torch

from henjou_torch.accel import bitonic
from henjou_torch.accel import pallas_binned as pb

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _sort_keys(kind, n, rng):
    if kind == "ties":
        return rng.integers(0, n // 8, n).astype(np.int32)
    key = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)  # any int32
    key[:4] = [-2**31, 2**31 - 1, -1, 0]
    key[4:n // 4] = key[rng.integers(0, 4, n // 4 - 4)]  # and ties among them
    return key


@pytest.mark.parametrize("cols", [8, 17])
@pytest.mark.parametrize("keys", ["ties", "negative"])
@pytest.mark.parametrize("n", [1024, 2048, 1 << 16, 1 << 17, 1 << 18])
def test_bitonic_kernel_matches_plain(cuda, n, keys, cols):
    """One launch of the network (and, at 17 columns, one more gather)
    against the stable argsort, every column bit-equal; the inverse."""
    rng = np.random.default_rng(n)
    key = torch.from_numpy(_sort_keys(keys, n, rng)).to(cuda)
    # [n] planes and [n, 3] rows, as the sorted intersector passes them;
    # 8 columns with the key and the lane id, or 17
    shapes = (n, (n, 3), (n, 3)) if cols == 8 else (n, (n, 3), (n, 3)) + (n,) * 9
    planes = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
              for shape in shapes]
    lane = torch.arange(n, dtype=torch.int32, device=cuda)
    before = bitonic.LAUNCHES
    out = bitonic.bitonic_sort(key, *planes, lane)
    ref = bitonic.bitonic_sort_plain(key, *planes, lane)
    torch.cuda.synchronize()
    assert bitonic.LAUNCHES == before + 1
    for a, b in zip(out, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    back = bitonic.bitonic_unsort(out[-1], *out[1:-1])
    for a, b in zip(back, planes):
        assert torch.equal(a, b)


def test_bitonic_kernel_rejects_bad_size(cuda):
    with pytest.raises(ValueError):
        bitonic.bitonic_sort(torch.zeros(1500, dtype=torch.int32, device=cuda))
    rows = torch.zeros((1024, 3), device=cuda)
    with pytest.raises(ValueError):  # a strided column view is not taken
        bitonic.bitonic_sort(torch.zeros(1024, dtype=torch.int32, device=cuda), rows[:, 0])


@pytest.mark.parametrize("any_hit", [False, True])
def test_binned_kernel_matches_plain(cuda, any_hit):
    rng = np.random.default_rng(5)
    c = rng.uniform(-3, 3, (2000, 1, 3))
    tris = (c + rng.normal(scale=0.25, size=(2000, 3, 3))).astype(np.float32)
    bc = pb.pack_binned_np(tris, cuda)
    n = 4096
    o = torch.from_numpy(rng.uniform(-4, 4, (n, 3)).astype(np.float32)).to(cuda)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True)).to(cuda)
    before = pb.LAUNCHES
    k = pb.intersect_binned(bc, o, d, 1e-3, any_hit=any_hit)
    p = pb.intersect_binned_plain(bc, o, d, 1e-3, any_hit=any_hit)
    torch.cuda.synchronize()
    assert pb.LAUNCHES == before + 1
    # built with --fmad=false: the same arithmetic in the same order
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert 0 < int(k[4].sum()) < n


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_sorted_binned_trace_at_the_masked_tile(cuda, any_hit):
    """The masked engine's trace: 131,072 rays (a tile), a scalar tmin and a
    per-lane tmax with dead lanes, through the bitonic sorted wrapper around
    the binned kernel, against the same wrapper over the plain versions:
    every result bit-equal, one sort and one inverse per trace."""
    from henjou_torch.accel.sorting import make_bitonic_sorted_intersector

    rng = np.random.default_rng(17)
    c = rng.uniform(-3, 3, (20000, 1, 3))
    tris = (c + rng.normal(scale=0.25, size=(20000, 3, 3))).astype(np.float32)
    bc = pb.pack_binned_np(tris, cuda)
    n = 1 << 17
    o = torch.from_numpy(rng.uniform(-4, 4, (n, 3)).astype(np.float32)).to(cuda)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True)).to(cuda)
    tmax = torch.from_numpy(np.where(rng.random(n) < 0.3, 0.0, 1e16).astype(np.float32)).to(cuda)
    tmin = torch.tensor(1e-4, device=cuda)
    kernels = make_bitonic_sorted_intersector(*pb.make_binned_intersector(bc), bc.scene_lo,
                                              bc.scene_hi)
    plain = make_bitonic_sorted_intersector(
        *pb.make_binned_intersector(bc, intersect=pb.intersect_binned_plain), bc.scene_lo,
        bc.scene_hi, sort=bitonic.bitonic_sort_plain, unsort=bitonic.bitonic_unsort_plain)
    fn, ref = (kernels[1], plain[1]) if any_hit else (kernels[0], plain[0])
    before = (bitonic.LAUNCHES, pb.LAUNCHES)
    got = fn(None, o, d, tmin, tmax)
    want = ref(None, o, d, tmin, tmax)
    torch.cuda.synchronize()
    assert (bitonic.LAUNCHES, pb.LAUNCHES) == (before[0] + 2, before[1] + 1)
    for a, b in zip((got,) if any_hit else got, (want,) if any_hit else want):
        assert torch.equal(a, b)
    assert not bool((got if any_hit else got[4])[tmax == 0].any())


def test_anim_refresh_on_cuda_matches_cpu(cuda):
    """`build_binned_from_order` on CUDA against the same torch ops on the
    CPU: every plane of rows, aabb and gaabb bit-equal (each op its own
    kernel, so nothing contracts into an FMA; min/max are exact)."""
    rng = np.random.default_rng(9)
    c = rng.uniform(-4, 4, (90000, 1, 3))
    tris = (c + rng.normal(scale=0.3, size=(90000, 3, 3))).astype(np.float32)
    order, *rest = pb.plan_binned_order(tris, [(0, 30000), (30000, 60000)])
    got = pb.build_binned_from_order(torch.from_numpy(tris).to(cuda), order, *rest)
    want = pb.build_binned_from_order(torch.from_numpy(tris), order, *rest)
    for f in ("rows", "aabb", "gaabb", "scene_lo", "scene_hi"):
        assert torch.equal(getattr(got, f).cpu().view(torch.int32),
                           getattr(want, f).view(torch.int32)), f


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", ["flat", "hbm", "mxu"])
def test_cluster_kernels_match_plain(cuda, kind, any_hit):
    """csrc/cluster.cu, cluster_hbm.cu and mxu.cu against their plain
    versions: equal to the bit (the same arithmetic in the same order,
    built with --fmad=false)."""
    from henjou_torch.accel import pallas_cluster as pc
    from henjou_torch.accel import pallas_cluster_hbm as hbm
    from henjou_torch.accel import pallas_mxu as mxu

    rng = np.random.default_rng(6)
    c = rng.uniform(-3, 3, (5000, 1, 3))
    tris = (c + rng.normal(scale=0.25, size=(5000, 3, 3))).astype(np.float32)
    mod, pack = {
        "flat": (pc, lambda: pc.pack_clusters(torch.from_numpy(tris).to(cuda))),
        "hbm": (hbm, lambda: hbm.pack_clusters_hbm_np(tris, cuda)),
        "mxu": (mxu, lambda: mxu.pack_clusters_mxu_np(tris, cuda)),
    }[kind]
    fn, plain = {
        "flat": (pc.intersect_pallas, pc.intersect_pallas_plain),
        "hbm": (hbm.intersect_pallas_hbm, hbm.intersect_pallas_hbm_plain),
        "mxu": (mxu.intersect_pallas_mxu, mxu.intersect_pallas_mxu_plain),
    }[kind]
    packed = pack()
    n = 4096
    o = torch.from_numpy(rng.uniform(-4, 4, (n, 3)).astype(np.float32)).to(cuda)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True)).to(cuda)
    tmax = torch.where(torch.arange(n, device=cuda) % 5 == 0, 0.0, 20.0)
    before = mod.LAUNCHES
    k = fn(packed, o, d, 1e-3, tmax, any_hit=any_hit)
    p = plain(packed, o, d, 1e-3, tmax, any_hit=any_hit)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 1
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert 0 < int(k[4].sum()) < n and not k[4][tmax == 0].any()


def _walk_scene(n_tri, copies, n_rays, seed):
    """`n_tri` small triangles in [-3, 3]^3, each repeated `copies` times
    (copies tie in t, inside a cluster or across two), and rays from
    [-4, 4]^3, half aimed at triangle centroids."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (n_tri, 1, 3))
    tris = np.repeat((c + rng.normal(scale=0.25, size=(n_tri, 3, 3))).astype(np.float32),
                     copies, axis=0)
    o = rng.uniform(-4, 4, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d[: n_rays // 2] = tris.mean(axis=1)[rng.integers(0, len(tris), n_rays // 2)] - o[: n_rays // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tris, o.astype(np.float32), d.astype(np.float32)


def _binned_pack(tris, group, dev, monkeypatch):
    """pack_binned_np with `group` clusters per group (1 below the pack's
    threshold of fine clusters; 16, 32 or 64 forced through it)."""
    if group > 1:
        c = -(-len(tris) // pb.K)
        monkeypatch.setattr(pb, "MAX_FINE_CLUSTERS", 0)
        monkeypatch.setattr(pb, "MAX_GROUPS", 1 if group == 64 else -(-c // group))
    bc = pb.pack_binned_np(tris, dev)
    assert bc.group == group
    return bc


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("case", [
    "binned group 1", "binned group 16", "binned group 32", "binned group 64",
    "binned ties", "hbm", "hbm ties", "hbm 33 superclusters",
    "flat", "flat ties", "mxu", "mxu ties", "mxu 33 superclusters",
])
def test_walk_kernels_match_plain(cuda, monkeypatch, case, any_hit, order):
    """binned.cu, cluster.cu, cluster_hbm.cu and mxu.cu (the warp-per-ray
    walk of csrc/cluster_walk.cuh) against their plain versions,
    bit-equal: packs of 1, 16, 32 and 64 clusters per group (40 groups of
    1: two box chunks; 64 clusters in a group: two cluster chunks), 40
    flat cluster boxes (two chunks), duplicated triangles, 33
    superclusters, dead lanes (tmax 0 and tmax == tmin), 4093 rays (not a
    multiple of a block's 4), unsorted or in the sorted wrapper's order."""
    from henjou_torch.accel import pallas_cluster as pc
    from henjou_torch.accel import pallas_cluster_hbm as hbm
    from henjou_torch.accel import pallas_mxu as mxu
    from henjou_torch.accel.sorting import DEAD_KEY, ray_sort_key

    n_tri, copies = (66_000, 1) if "33" in case else (1700, 3) if "ties" in case else (5000, 1)
    tris, o, d = _walk_scene(n_tri, copies, 4093, seed=9)
    if case.startswith("binned"):
        mod, fn, plain = pb, pb.intersect_binned, pb.intersect_binned_plain
        packed = _binned_pack(tris, int(case.split()[-1]) if "group" in case else 1, cuda,
                              monkeypatch)
    elif case.startswith("flat"):
        mod, fn, plain = pc, pc.intersect_pallas, pc.intersect_pallas_plain
        packed = pc.pack_clusters(torch.from_numpy(tris).to(cuda))
        assert packed.num_clusters == 40
    else:
        mod, fn, plain = {
            "hbm": (hbm, hbm.intersect_pallas_hbm, hbm.intersect_pallas_hbm_plain),
            "mxu": (mxu, mxu.intersect_pallas_mxu, mxu.intersect_pallas_mxu_plain),
        }[case.split()[0]]
        packed = (hbm.pack_clusters_hbm_np if mod is hbm else mxu.pack_clusters_mxu_np)(tris, cuda)
        assert packed.num_super == (33 if "33" in case else 3)
    o, d = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    n = o.shape[0]
    lane = torch.arange(n, device=cuda)
    tmin = torch.full((n,), 1e-3, device=cuda)
    tmax = torch.where(lane % 7 == 0, 0.0, 20.0)
    tmax = torch.where(lane % 11 == 0, tmin, tmax)
    if order == "sorted":
        lo = torch.from_numpy(tris.reshape(-1, 3).min(0)).to(cuda)
        hi = torch.from_numpy(tris.reshape(-1, 3).max(0)).to(cuda)
        key = ray_sort_key(o, d, lo, 1.0 / torch.clamp(hi - lo, min=1e-12))
        perm = torch.argsort(torch.where(tmax > tmin, key, DEAD_KEY), stable=True)
        o, d, tmin, tmax = o[perm], d[perm], tmin[perm], tmax[perm]
    before = mod.LAUNCHES
    k = fn(packed, o, d, tmin, tmax, any_hit=any_hit)
    p = plain(packed, o, d, tmin, tmax, any_hit=any_hit)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 1
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert 0 < int(k[4].sum()) < n and not k[4][tmax <= tmin].any()


@pytest.fixture
def net_state(cuda):
    """A [10, 65536] int32 network state on the card, keys with ties."""
    rng = np.random.default_rng(7)
    st = rng.integers(-2**31, 2**31 - 1, (10, 1 << 16)).astype(np.int32)
    st[0] = rng.integers(0, 1 << 12, 1 << 16)
    return torch.from_numpy(st).to(cuda)


@pytest.mark.parametrize("k,j,per_plane,mode,guards", [
    (32, 16, False, "static", 0), (1024, 512, True, "static", 0),
    (16, 16, False, "static_j", 0), (1 << 16, 1 << 15, True, "static_j", 0),
    (2, 1, False, "dynamic", 0), (4096, 2048, True, "dynamic", 0),
    (32, 16, False, "static", 4), (32, 16, False, "static", 16),
])
def test_net_substage_kernel_matches_plain(net_state, k, j, per_plane, mode, guards):
    from henjou_torch.accel import bitonic_net as bn

    kw = dict(per_plane=per_plane, mode=mode, guards=guards, lj=0)
    before = bn.LAUNCHES["net_substage"]
    out = bn.net_substage(net_state, k, j, **kw)
    ref = bn.net_substage_plain(net_state, k, j, **kw)
    torch.cuda.synchronize()
    assert bn.LAUNCHES["net_substage"] == before + 1
    assert torch.equal(out, ref)


def test_net_local_kernel_matches_plain(net_state):
    from henjou_torch.accel import bitonic_net as bn

    subs = [kj for kj in bn.substages(1 << 16) if kj[0] <= 1024]
    for lst in (subs, [(32, 16)] * 136):
        before = bn.LAUNCHES["net_local"]
        out = bn.net_local(net_state, lst)
        torch.cuda.synchronize()
        assert bn.LAUNCHES["net_local"] == before + 1
        assert torch.equal(out, bn.net_local_plain(net_state, lst))


def _net_input(cuda, p, n, seed):
    """[p, n] int32 on the card: keys with ties in [0, 64) and, in a
    quarter of the elements, both int32 extremes; planes over the range."""
    rng = np.random.default_rng(seed)
    st = rng.integers(-2**31, 2**31 - 1, (p, n)).astype(np.int32)
    st[0] = rng.integers(0, 64, n)
    st[0, ::8] = -2**31
    st[0, 1::8] = 2**31 - 1
    return torch.from_numpy(st).to(cuda)


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("p", [1, 2, 5, 10, 17])
@pytest.mark.parametrize("n", [1024, 1 << 18])
def test_net_substage_kernel_every_j(cuda, n, p, inplace):
    """Every log2 j with k above, equal to and at n, in every mode, stacked
    (in place or not) and per plane (not in place), and the guard chains:
    bit-equal to the plain version, one launch per call."""
    from henjou_torch.accel import bitonic_net as bn

    state = _net_input(cuda, p, n, seed=p)
    forms = [(False, "dynamic"), (False, "static_j")]
    if not inplace:
        forms += [(True, "dynamic"), (True, "static_j")]
    for lj in range(n.bit_length() - 1):
        j = 1 << lj
        for k in sorted({min(2 * j, n), j, n}):
            cases = [dict(per_plane=pp, mode=m) for pp, m in forms
                     if m != "static_j" or j <= bn.MAX_STATIC_J]
            if (k, j) in bn.STATIC_PAIRS:
                cases += [dict(per_plane=pp, mode="static") for pp, _ in forms[::2]]
                if (k, j) == (32, 16):
                    cases += [dict(mode="static", guards=g, lj=0) for g in bn.GUARDS]
            for kw in cases:
                ref = bn.net_substage_plain(state, k, j, **kw)
                src = state.clone() if inplace else state
                before = bn.LAUNCHES["net_substage"]
                out = bn.net_substage(src, k, j, dst=src if inplace else None, **kw)
                torch.cuda.synchronize()
                assert bn.LAUNCHES["net_substage"] == before + 1
                assert torch.equal(out, ref), (k, j, kw)


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("p", [1, 2, 5, 10, 17])
@pytest.mark.parametrize("n", [1024, 1 << 18])
def test_net_local_kernel_lists(cuda, n, p, inplace):
    """Row C's 136 x (32, 16), the k <= 1024 list, MIXED_SUBS's j < 1024
    substages and a list whose k exceeds the tile, bit-equal to the plain
    version, one launch per call; the kernel's plan equals plan_local's."""
    from henjou_torch.accel import bitonic_net as bn

    state = _net_input(cuda, p, n, seed=20 + p)
    subs = bn.substages(n)
    lists = ([(32, 16)] * 136, [kj for kj in subs if kj[0] <= 1024],
             [kj for kj in bn.MIXED_SUBS if kj[1] < 1024],
             [(n, j) for j in (128, 64, 32, 16, 8, 4, 2, 1)] + [(n // 2, 64)])
    for lst in lists:
        codes, layouts = bn.local_plan_codes(lst)
        assert bn.kernel_local_plan(lst) == (codes, layouts, bn.plan_local(lst).bits)
        ref = bn.net_local_plain(state, lst)
        src = state.clone() if inplace else state
        before = bn.LAUNCHES["net_local"]
        out = bn.net_local(src, lst, dst=src if inplace else None)
        torch.cuda.synchronize()
        assert bn.LAUNCHES["net_local"] == before + 1
        assert torch.equal(out, ref)


def test_net_kernels_reject_a_misaligned_state(cuda):
    from henjou_torch.accel import bitonic_net as bn

    flat = torch.zeros(3 * 1024 + 1, dtype=torch.int32, device=cuda)
    state = flat[1:].view(3, 1024)
    assert state.is_contiguous() and state.data_ptr() % 16
    with pytest.raises(ValueError):
        bn.net_substage(state, 32, 16)
    with pytest.raises(ValueError):
        bn.net_local(state, [(32, 16)])
    with pytest.raises(ValueError):
        bn.net_substage(flat[:3072].view(3, 1024), 32, 16, dst=state)


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("switch", [False, True])
@pytest.mark.parametrize("which", ["full", "odd55", "mixed k == j"])
def test_net_walk_kernel_matches_plain(net_state, which, inplace, switch):
    """One cooperative launch of the network: the full 136-substage
    schedule, the first 55 substages, and a schedule with k == j."""
    from henjou_torch.accel import bitonic_net as bn

    n = net_state.shape[1]
    subs = {"full": bn.substages(n), "odd55": bn.substages(n)[:55],
            "mixed k == j": bn.MIXED_SUBS}
    sched = bn.make_schedule(subs[which], n, net_state.device)
    ref = bn.net_walk_plain(net_state, sched)
    before = bn.LAUNCHES["net_walk"]
    state = net_state.clone() if inplace else net_state
    out = bn.net_walk(state, sched, inplace=inplace, switch=switch)
    torch.cuda.synchronize()
    assert bn.LAUNCHES["net_walk"] == before + 1
    assert (out is state) == inplace
    assert torch.equal(out, ref)
    if len(sched.subs) == len(bn.substages(n)):
        assert bool((out[0][1:] >= out[0][:-1]).all())


@pytest.mark.parametrize("inplace", [False, True])
def test_net_walk_kernel_negative_keys_and_many_planes(cuda, inplace):
    """Keys over the whole int32 range and 20 planes, so that three planes
    are gathered after the network (and copied back in place)."""
    from henjou_torch.accel import bitonic_net as bn

    n = 1 << 16
    rng = np.random.default_rng(8)
    st = rng.integers(-2**31, 2**31 - 1, (20, n)).astype(np.int32)
    st[0] = _sort_keys("negative", n, rng)
    state = torch.from_numpy(st).to(cuda)
    sched = bn.make_schedule(bn.substages(n), n, cuda)
    ref = bn.net_walk_plain(state, sched)
    out = bn.net_walk(state.clone() if inplace else state, sched, inplace=inplace)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("per_plane", [False, True])
def test_roll_pass_kernel_matches_plain(net_state, per_plane):
    from henjou_torch.accel import bitonic_net as bn

    before = bn.LAUNCHES["roll_pass"]
    out = bn.roll_pass(net_state, per_plane=per_plane)
    torch.cuda.synchronize()
    assert bn.LAUNCHES["roll_pass"] == before + 1
    assert torch.equal(out, bn.roll_pass_plain(net_state))


# ---------------- the denoiser: CUDA tensors against CPU tensors ----------------


def _denoise_inputs(h=72, w=128, seed=21):
    """AOVs of order 1 (some zero albedo for the demodulation guard, unit
    normals in patches), variance, counts, a history close to the current
    frame, and a reprojection near the identity with fractional parts in
    [0.05, 0.95]: numpy arrays."""
    rng = np.random.default_rng(seed)
    color = rng.random((h, w, 3), dtype=np.float32) * 1.5
    albedo = rng.random((h, w, 3), dtype=np.float32)
    albedo[rng.random((h, w)) < 0.1] = 0.0
    n = np.repeat(np.repeat(rng.normal(size=(h // 4 + 1, w // 4 + 1, 3)), 4, 0), 4, 1)[:h, :w]
    normal = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    variance = rng.random((h, w), dtype=np.float32) * 0.02
    count = rng.integers(1, 9, (h, w)).astype(np.float32)
    iy, ix = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    px = (ix + rng.integers(-1, 2, (h, w)) + rng.uniform(0.05, 0.95, (h, w))).astype(np.float32)
    py = (iy + rng.integers(-1, 2, (h, w)) + rng.uniform(0.05, 0.95, (h, w))).astype(np.float32)
    valid = rng.random((h, w)) > 0.1
    hist = (color + 0.1 * (rng.random((h, w, 3), dtype=np.float32) - 0.5)).astype(np.float32)
    return dict(color=color, albedo=albedo, normal=normal, variance=variance, count=count,
                hist=hist, px=px, py=py, valid=valid)


def _denoise_call(name, x):
    """(function, positional args) of one denoiser function on the dict of
    tensors `x`; the 2x upscalers take the frame as the half-size input."""
    from henjou_torch.post import denoise as dn

    c, a, nrm = x["color"], x["albedo"], x["normal"]
    return {
        "denoise_atrous": (dn.denoise_atrous, (c, a, nrm)),
        "denoise_atrous_var": (dn.denoise_atrous_var, (c, a, nrm, x["variance"])),
        "denoise_temporal": (dn.denoise_temporal, (c, a, nrm, x["hist"], a, nrm)),
        "denoise_temporal_reprojected": (dn.denoise_temporal_reprojected,
                                         (c, a, nrm, x["hist"], a, nrm, x["px"], x["py"],
                                          x["valid"])),
        "temporal_accumulate": (dn.temporal_accumulate,
                                (c, x["variance"], x["count"], a, nrm, x["hist"],
                                 x["variance"], 3.0 * x["count"], a, nrm, x["px"], x["py"],
                                 x["valid"])),
        "upscale2x_guided": (dn.upscale2x_guided,
                             (c, a, nrm, dn.upscale2x(a), dn.upscale2x(nrm))),
        "upscale2x": (dn.upscale2x, (c,)),
    }[name]


@pytest.mark.parametrize("name", ["denoise_atrous", "denoise_atrous_var", "denoise_temporal",
                                  "denoise_temporal_reprojected", "temporal_accumulate",
                                  "upscale2x_guided", "upscale2x"])
def test_denoiser_on_cuda_matches_cpu(cuda, name):
    """The same tensor ops on the card and on the CPU, at the CPU parity
    tests' limit: rtol 1e-4, atol 1e-5."""
    arrays = _denoise_inputs()
    on = {dev: {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
          for dev in ("cpu", cuda)}
    fn, args = _denoise_call(name, on[cuda])
    got = fn(*args)
    fn, args = _denoise_call(name, on["cpu"])
    want = fn(*args)
    got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


def test_sobol_draws_on_cuda_match_cpu(cuda):
    """Tagged and untagged CMJ states, three draws deep, bit-equal on the
    card and on the CPU (integer hashing; the f32 scale is exact)."""
    from henjou_torch.sampling import cmj

    rng = np.random.default_rng(3)
    n = 1 << 16
    spp = torch.from_numpy(rng.integers(0, 4096, n))
    pix = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.int64))
    seed = torch.from_numpy(rng.integers(0, 1 << 31, n) | np.where(np.arange(n) % 2 == 0,
                                                                    cmj.SOBOL_SEED_FLAG, 0))
    states = {dev: cmj.make_cmj_state(spp.to(dev), pix.to(dev), seed.to(dev), sobol=True)
              for dev in ("cpu", cuda)}
    for _ in range(3):
        want, states["cpu"] = cmj.cmj_2d(states["cpu"])
        got, states[cuda] = cmj.cmj_2d(states[cuda])
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


def test_pool_sort_27_columns_matches_plain(cuda):
    """The wavefront pool re-sort's call: 65,536 lanes, the key and 27
    payload columns ([n] and [n, 3] planes of i32 and f32), so one network
    launch and one gather launch in one wrapper call; bit-equal to the
    stable argsort."""
    n = 1 << 16
    rng = np.random.default_rng(27)
    key = torch.from_numpy(rng.integers(0, 1 << 24, n).astype(np.int32))
    key[rng.uniform(size=n) < 0.3] = (1 << 30) - 1  # dead lanes
    shapes = [(n,), (n, 3), (n, 3), (n,), (n,), (n,), (n,), (n, 3), (n, 3), (n, 3), (n, 3),
              (n,), (n,), (n,), (n,)]
    planes = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) if i % 2 else
              torch.from_numpy(rng.integers(-2**31, 2**31, s, dtype=np.int64).astype(np.int32))
              for i, s in enumerate(shapes)]
    assert sum(1 if p.dim() == 1 else p.shape[1] for p in planes) == 27
    before = bitonic.LAUNCHES
    got = bitonic.bitonic_sort(key.to(cuda), *(p.to(cuda) for p in planes))
    torch.cuda.synchronize()
    assert bitonic.LAUNCHES == before + 1
    for g, w in zip(got, bitonic.bitonic_sort_plain(key, *planes)):
        assert torch.equal(g.cpu(), w)


def _cmj_state(cuda, shape, sobol, seed):
    """A CUDA state of random u32 fields from numpy, its first lanes the
    edge values: 0 and 0xFFFFFFFF in every field, n_spp >= 16, depth
    0xFFFFFFFF (which wraps); with `sobol`, the tag bit on every other
    lane."""
    from henjou_torch.sampling import cmj

    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    f = rng.integers(0, 1 << 32, (4, n), dtype=np.uint64).astype(np.int64)
    edge = np.array([[0, 0, 0, 0], [0xFFFFFFFF] * 4, [16, 7, 0xFFFFFFFF, 5],
                     [4095, 0x7FFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF]], np.int64).T
    k = min(n, edge.shape[1])
    f[:, :k] = edge[:, :k]
    if sobol:
        f[1] = np.where(np.arange(n) % 2 == 0, f[1] | cmj.SOBOL_SEED_FLAG,
                        f[1] & ~cmj.SOBOL_SEED_FLAG)
    n_spp, scramble, depth, pix = (torch.from_numpy(x.reshape(shape)).to(cuda) for x in f)
    return cmj.CMJState(n_spp=n_spp, scramble=scramble, depth=depth, image_idx=pix, sobol=sobol)


@pytest.mark.parametrize("sobol", [False, True], ids=["cmj", "sobol"])
@pytest.mark.parametrize("shape", [(0,), (1,), (1000,), (131072,), (921600,), (0, 3), (1, 1),
                                   (8, 125), (256, 512), (720, 1280)], ids=str)
@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_cmj_kernel_matches_plain(cuda, width, shape, sobol):
    """One launch per draw, bit-equal to the torch code on the same state:
    the values, their shape and the new depth; the state given unchanged."""
    from henjou_torch.sampling import cmj

    st = _cmj_state(cuda, shape, sobol, width * 7 + len(shape))
    before = [x.clone() for x in st[:4]]
    launches = cmj.LAUNCHES
    got, new = getattr(cmj, f"cmj_{width}d")(st)
    torch.cuda.synchronize()
    assert cmj.LAUNCHES == launches + 1
    want, want_st = cmj.draw_plain(st, width)
    assert got.device == want.device and got.dtype == torch.float32
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(new.depth, want_st.depth) and new.sobol == sobol
    for a, b in zip(st[:4], before):
        assert torch.equal(a, b)
    for name in ("n_spp", "scramble", "image_idx"):
        assert getattr(new, name) is getattr(st, name)


@pytest.mark.parametrize("sobol", [False, True], ids=["cmj", "sobol"])
@pytest.mark.parametrize("shape", [(131072,), (720, 1280)], ids=str)
def test_cmj_kernel_chain_of_five_draws(cuda, shape, sobol):
    """cmj_2d, cmj_1d, cmj_4d, cmj_3d, cmj_2d threaded through one state on
    the kernel and on the torch code: every value and depth bit-equal."""
    from henjou_torch.sampling import cmj

    st = plain = _cmj_state(cuda, shape, sobol, 5)
    launches = cmj.LAUNCHES
    for width in (2, 1, 4, 3, 2):
        got, st = getattr(cmj, f"cmj_{width}d")(st)
        want, plain = cmj.draw_plain(plain, width)
        assert torch.equal(got, want) and torch.equal(st.depth, plain.depth)
    torch.cuda.synchronize()
    assert cmj.LAUNCHES == launches + 5
