"""The order of the cluster walk of csrc/cluster_walk.cuh (the binned,
flat, two-level and matrix-form kernels), modelled step for step in plain torch by
`henjou_torch.accel.cluster_walk`: lane l owns triangles 4l..4l+3, the box
levels go in chunks of 32 re-tested against the current best t, each lane
picks its candidate and a butterfly on (t, k) picks the cluster's, an any
hit takes the lowest lane and its first k, a dead ray retires at once.

The model is held bit-equal to the plain versions (`_intersect_plain`),
which the kernels equal on the card (tests/test_torch_cuda.py), with the
same (ray, cluster) visits; and against the JAX kernels in interpret mode
with ROADMAP Queue 3's tolerances: XLA's FMA contraction moves t, u and v
by ulps of each hit's conditioning, and the TPU kernels visit clusters
nearest-first per tile, so no scene with ties is compared there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from henjou_torch.accel import cluster_walk as cw
from henjou_torch.accel import pallas_binned as tpb
from henjou_torch.accel import pallas_cluster as tpc
from henjou_torch.accel import pallas_cluster_hbm as thbm
from henjou_torch.accel import pallas_mxu as tmxu
from henjou_tpu.accel import pallas_binned as jpb
from henjou_tpu.accel import pallas_cluster as jpc
from henjou_tpu.accel import pallas_cluster_hbm as jhbm
from henjou_tpu.accel import pallas_mxu as jmxu

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

CASES = {  # case: (triangles, copies of each, rays)
    "binned group 1": (5000, 1, 1024),  # 40 groups of 1: two box chunks
    "binned group 16": (5000, 1, 1024),  # 3 groups, 8 padding slots
    "binned group 32": (5000, 1, 1024),
    "binned group 64": (5000, 1, 1024),  # 64 clusters in a group: two chunks
    "binned ties": (1700, 3, 1024),
    "hbm": (5000, 1, 1024),
    "hbm ties": (1700, 3, 1024),
    "hbm 33 superclusters": (66_000, 1, 384),  # two box chunks
    "flat": (5000, 1, 1024),  # 40 cluster boxes: two top chunks
    "flat ties": (1700, 3, 1024),
    "mxu": (5000, 1, 1024),
    "mxu ties": (1700, 3, 1024),
    "mxu 33 superclusters": (66_000, 1, 384),
}


@functools.lru_cache(maxsize=None)
def _scene(n_tri, copies, n_rays, seed=9):
    """`n_tri` small triangles in [-3, 3]^3, each repeated `copies` times
    (the copies tie in t), and rays from [-4, 4]^3, half aimed at triangle
    centroids."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (n_tri, 1, 3))
    tris = np.repeat((c + rng.normal(scale=0.25, size=(n_tri, 3, 3))).astype(np.float32),
                     copies, axis=0)
    o = rng.uniform(-4, 4, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d[: n_rays // 2] = tris.mean(axis=1)[rng.integers(0, len(tris), n_rays // 2)] - o[: n_rays // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tris, o.astype(np.float32), d.astype(np.float32)


def _pack(case, tris, monkeypatch):
    """(plain-version module, pack, walk model) of a case; binned packs of
    16, 32 and 64 clusters per group through the pack's thresholds."""
    if case.startswith("flat"):
        return tpc, tpc.pack_clusters(torch.from_numpy(tris)), cw.walk_flat
    if case.startswith("mxu"):
        return tmxu, tmxu.pack_clusters_mxu_np(tris, "cpu"), cw.walk_mxu
    if case.startswith("hbm"):
        return thbm, thbm.pack_clusters_hbm_np(tris, "cpu"), cw.walk_hbm
    group = int(case.split()[-1]) if "group" in case else 1
    if group > 1:
        c = -(-len(tris) // tpb.K)
        monkeypatch.setattr(tpb, "MAX_FINE_CLUSTERS", 0)
        monkeypatch.setattr(tpb, "MAX_GROUPS", 1 if group == 64 else -(-c // group))
    bc = tpb.pack_binned_np(tris, "cpu")
    assert bc.group == group
    return tpb, bc, cw.walk_binned


def _rays(case):
    """The case's rays with tmin 1e-3 and dead lanes: tmax 0 on every 7th,
    tmax == tmin on every 11th."""
    tris, o, d = _scene(*CASES[case])
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    lane = torch.arange(o.shape[0])
    tmin = torch.full((o.shape[0],), 1e-3)
    tmax = torch.where(lane % 7 == 0, 0.0, 20.0)
    return tris, o, d, tmin, torch.where(lane % 11 == 0, tmin, tmax)


def _prepare(mod, pack, o, d, tmin, tmax):
    if mod is tpb:
        return tpb._prepare(pack, o, d, tmin, tmax)
    return tpc._prepare(o, d, tmin, tmax, pack.aabb)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("case", list(CASES))
def test_walk_model_matches_plain(case, any_hit, monkeypatch):
    """The kernel's order gives the plain version's t, prim, u and v to the
    bit, and visits the same (ray, cluster) pairs (a binned any-hit ray
    stops at its hit, where the plain version may still visit later
    clusters of the group)."""
    tris, o, d, tmin, tmax = _rays(case)
    mod, pack, model = _pack(case, tris, monkeypatch)
    tn, tx = _prepare(mod, pack, o, d, tmin, tmax)
    plain = mod._intersect_plain(pack, o, d, tn, tx, any_hit)
    got, visits = model(pack, o, d, tn, tx, any_hit)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    hit = got[1] >= 0
    assert 50 < int(hit.sum()) < o.shape[0] and not hit[tmax <= tmin].any()
    live = tmax > tmin  # the plain version may visit a box at t == tmin == tmax
    mod.VISITS = 0
    mod._intersect_plain(pack, o[live], d[live], tn[live], tx[live], any_hit)
    if any_hit and mod is tpb:
        assert 0 < visits <= mod.VISITS
    else:
        assert visits == mod.VISITS > 0


@pytest.mark.parametrize("case", ["binned ties", "hbm ties", "flat ties", "mxu ties"])
def test_walk_model_ties_take_the_first_copy(case, monkeypatch):
    """Three copies of each triangle tie in t; the closest hit is the copy
    the walk reaches first (the earlier cluster, then the lower k), and the
    scene has copies across two clusters and across two lanes of one."""
    tris, o, d, tmin, tmax = _rays(case)
    mod, pack, model = _pack(case, tris, monkeypatch)
    tn, tx = _prepare(mod, pack, o, d, tmin, tmax)
    (_, prim, _, _), _ = model(pack, o, d, tn, tx, False)
    ids = (pack.rows.view(-1, 16, tpb.K)[:, 12].view(torch.int32) if mod is tpb
           else pack.order).reshape(-1)
    pos = torch.full((len(tris),), -1, dtype=torch.int64)
    pos[ids[ids >= 0].long()] = torch.nonzero(ids >= 0)[:, 0]  # walk position of each id
    copies = pos.view(-1, 3)  # ids 3i, 3i+1, 3i+2 are one triangle's copies
    cluster, lane = copies // tpb.K, copies % tpb.K // cw.TRIS_PER_LANE
    assert bool((cluster[:, 0] != cluster[:, 2]).any())
    assert bool(((cluster[:, 0] == cluster[:, 2]) & (lane[:, 0] != lane[:, 2])).any())
    hit = prim >= 0
    assert int(hit.sum()) > 300
    first = copies.min(dim=1).values
    assert torch.equal(pos[prim[hit].long()], first[prim[hit].long() // 3])


def test_hbm_any_hit_takes_the_first_k_not_the_nearest(monkeypatch):
    """The two-level any hit returns its first accepted triangle's own t,
    which for some rays lies beyond the closest hit."""
    tris, o, d, tmin, tmax = _rays("hbm")
    mod, pack, model = _pack("hbm", tris, monkeypatch)
    tn, tx = _prepare(mod, pack, o, d, tmin, tmax)
    (t_c, _, _, _), _ = model(pack, o, d, tn, tx, False)
    (t_a, p_a, _, _), _ = model(pack, o, d, tn, tx, True)
    hit = p_a >= 0
    assert int((t_a[hit] > t_c[hit]).sum()) > 0
    assert bool((t_a[hit] >= t_c[hit]).all())


def _mt_kappa(o, d, tv):
    """kappa of t, u and v for rays o, d [n,3] at triangles tv [n,3,3] in
    float64 (tests/test_torch_cluster.py): the sum of |terms| of each
    numerator over |det|, plus det's own conditioning times |value|."""
    o, d, tv = (np.asarray(x, np.float64) for x in (o, d, tv))
    e1, e2, tvec = tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0], o - tv[:, 0]
    pv, qv = np.cross(d, e2), np.cross(tvec, e1)
    det_t = e1 * pv
    det = np.abs(det_t.sum(1))
    k_det = np.abs(det_t).sum(1) / det
    return [np.abs(x).sum(1) / det + k_det * np.abs(x.sum(1) / det)
            for x in (e2 * qv, tvec * pv, d * qv)]


def _bw_kappa_t(bc, prim, o, d):
    """kappa of the Baldwin-Weber t = (d_pl - n.o) / (n.d) at the packed
    rows of triangles `prim`, in float64: the sum of |terms| over |sum| of
    the numerator and of the denominator."""
    rows = bc.rows.view(-1, 16, tpb.K).double().numpy()
    ids = bc.rows.view(-1, 16, tpb.K)[:, 12].view(torch.int32).reshape(-1).numpy()
    where = np.full(ids.max() + 1, -1)
    where[ids[ids >= 0]] = np.nonzero(ids >= 0)[0]
    c, k = where[prim] // tpb.K, where[prim] % tpb.K
    n, dpl = rows[c, 0:3, k], rows[c, 3, k]
    num = np.concatenate([dpl[:, None], -n * o], axis=1)
    den = n * d
    return (np.abs(num).sum(1) / np.abs(num.sum(1))
            + np.abs(den).sum(1) / np.abs(den.sum(1)))


def _mxu_kappa(mc, prim, o, d):
    """kappa of t, u and v of the matrix form at the packed G columns of
    triangles `prim`, in float64: the ten terms F_q * G_q of det and of
    each numerator (tests/test_torch_cluster.py)."""
    order = mc.order.numpy().reshape(-1)
    where = np.full(order.max() + 1, -1)
    where[order[order >= 0]] = np.nonzero(order >= 0)[0]
    c, k = where[prim] // tmxu.K, where[prim] % tmxu.K
    g = mc.g_rows.numpy().reshape(-1, tmxu.NF, 4, tmxu.K)[c, :10, :, k].astype(np.float64)
    op = o - mc.centers.numpy()[0:3, c // tmxu.SC].T.astype(np.float64)
    f = np.stack([d[:, 0], d[:, 1], d[:, 2], d[:, 1] * op[:, 2] - d[:, 2] * op[:, 1],
                  d[:, 2] * op[:, 0] - d[:, 0] * op[:, 2], d[:, 0] * op[:, 1] - d[:, 1] * op[:, 0],
                  op[:, 0], op[:, 1], op[:, 2], np.ones_like(d[:, 0])], 1)
    det_t, u_t, v_t, t_t = (f * g[:, :, i] for i in range(4))
    det = np.abs(det_t.sum(1))
    k_det = np.abs(det_t).sum(1) / det
    return [np.abs(x).sum(1) / det + k_det * np.abs(x.sum(1) / det) for x in (t_t, u_t, v_t)]


_INTERPRET = {  # kind: (case, JAX pack builder, JAX kernel)
    "binned": ("binned group 1", jpb.pack_binned_np, jpb.intersect_binned),
    "hbm": ("hbm", jhbm.pack_clusters_hbm_np, jhbm.intersect_pallas_hbm),
    "flat": ("flat", lambda tris: jpc.pack_clusters(jnp.asarray(tris)), jpc.intersect_pallas),
    "mxu": ("mxu", jmxu.pack_clusters_mxu_np, jmxu.intersect_pallas_mxu),
}


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", list(_INTERPRET))
def test_walk_model_matches_interpret(kind, any_hit, monkeypatch):
    """The model against the JAX kernels in interpret mode: hit flips at
    most 1e-4 of the rays (binned; none for the Moller-Trumbore kernels),
    prims equal; t, u and v within 8 ulps of each hit's conditioning
    (tests/test_torch_cluster.py; for binned t, the Baldwin-Weber
    quotient's; for the matrix form, its ten-term sums'), and binned u, v
    within 5e-5 (tests/test_torch_accel.py)."""
    case, jpack, jfn = _INTERPRET[kind]
    tris, o, d = _scene(*CASES[case])
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    mod, pack, model = _pack(case, tris, monkeypatch)
    tn, tx = _prepare(mod, pack, o_t, d_t, 1e-3, 20.0)
    (t, prim, u, v), _ = model(pack, o_t, d_t, tn, tx, any_hit)
    hit = (prim >= 0).numpy()
    ref = jfn(jpack(tris), jo, jd, 1e-3, 20.0, any_hit=any_hit, interpret=True)
    if kind == "binned":
        assert (np.asarray(ref[4]) != hit).sum() <= 1e-4 * len(o)
    else:
        np.testing.assert_array_equal(np.asarray(ref[4]), hit)
    assert 200 < hit.sum() < len(o)
    if any_hit:
        return
    both = hit & np.asarray(ref[4])
    r_t, r_p, r_u, r_v = (np.asarray(x)[both] for x in ref[:4])
    g_t, g_p, g_u, g_v = (x.numpy()[both] for x in (t, prim, u, v))
    np.testing.assert_array_equal(g_p, r_p)
    if kind == "binned":
        kappa = _bw_kappa_t(pack, g_p, o[both].astype(np.float64), d[both].astype(np.float64))
        assert (np.abs(g_t.astype(np.float64) - r_t) <= 8 * 2.0**-23 * kappa * np.abs(r_t)).all()
        for a, b in ((g_u, r_u), (g_v, r_v)):
            np.testing.assert_allclose(a, b, rtol=0, atol=5e-5)
        return
    o64, d64 = o[both].astype(np.float64), d[both].astype(np.float64)
    kappas = (_mxu_kappa(pack, g_p, o64, d64) if kind == "mxu"
              else _mt_kappa(o[both], d[both], tris[g_p]))
    for a, b, kappa in zip((g_t, g_u, g_v), (r_t, r_u, r_v), kappas):
        assert (np.abs(a.astype(np.float64) - b) <= 8 * 2.0**-23 * kappa).all()
