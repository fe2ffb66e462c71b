"""Port parity of the three cluster intersectors (flat scan, two-level,
matrix form): their packs against the JAX package's, bit for bit, and their
plain versions (the CPU path of each kernel wrapper) against the JAX
kernels in interpret mode.

Against the JAX kernels: hit flags equal, prim equal (no ties in t among
these scattered triangles), and t, u and v each within 8 float32 ulps of
the cancellation its formula goes through: |error| <= 8 * 2^-23 * kappa,
with kappa = (sum of |terms| of the numerator) / |det| + (sum of |terms|
of det) / |det| * |value|, computed in float64 from the geometry. A fixed
limit does not hold: XLA on the CPU contracts a*b+c into FMAs and the port
does not (ROADMAP Queue 3), and a grazing ray at a 0.3-wide triangle
several units away has kappa near 1e4, so one rounding difference moves u
by ~1e-4 (the largest ratio measured over 39 such scenes was 2.9 ulps of
kappa for the Moller-Trumbore kernels and 1.2 for the matrix form). The
port's own arithmetic is held to the bit: t, u and v equal a numpy float32
evaluation of the kernels' operation order, which has no FMA.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from henjou_torch.accel import pallas_cluster as tpc
from henjou_torch.accel import pallas_cluster_hbm as thbm
from henjou_torch.accel import pallas_mxu as tmxu
from henjou_tpu.accel import pallas_cluster as jpc
from henjou_tpu.accel import pallas_cluster_hbm as jhbm
from henjou_tpu.accel import pallas_mxu as jmxu

from tests import torch_interop as interop

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

N_TRI, N_RAY = 300, 256
ULPS = 8
EPS32 = 2.0**-23


@functools.lru_cache(maxsize=None)
def _scene():
    """300 small triangles in [-4, 4]^3 and 256 rays from [-6, 6]^3, half
    of them aimed at triangle centroids (random rays hit few)."""
    rng = np.random.default_rng(7)
    centers = rng.uniform(-4, 4, (N_TRI, 1, 3))
    tris = (centers + rng.uniform(-0.3, 0.3, (N_TRI, 3, 3))).astype(np.float32)
    o = rng.uniform(-6, 6, (N_RAY, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAY, 3)).astype(np.float32)
    aim = tris.mean(axis=1)[rng.integers(0, N_TRI, N_RAY // 2)]
    d[: N_RAY // 2] = aim - o[: N_RAY // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tris, o, d


@functools.lru_cache(maxsize=None)
def _packs():
    """(JAX pack, port pack) per kernel."""
    tris, _, _ = _scene()
    return {
        "flat": (jpc.pack_clusters(jnp.asarray(tris)), tpc.pack_clusters(torch.from_numpy(tris))),
        "hbm": (jhbm.pack_clusters_hbm(jnp.asarray(tris)),
                thbm.pack_clusters_hbm(torch.from_numpy(tris))),
        "hbm_np": (jhbm.pack_clusters_hbm_np(tris), thbm.pack_clusters_hbm_np(tris, "cpu")),
        "mxu": (jmxu.pack_clusters_mxu_np(tris), tmxu.pack_clusters_mxu_np(tris, "cpu")),
    }


_FIELDS = {
    "flat": ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z", "order", "aabb"),
    "hbm": ("rows", "order", "aabb", "aabb2"),
    "hbm_np": ("rows", "order", "aabb", "aabb2"),
    "mxu": ("g_rows", "order", "aabb", "aabb2", "centers"),
}
_FROM_NUMPY = {"flat": interop.packed_from_numpy, "hbm": interop.hbm_from_numpy,
               "hbm_np": interop.hbm_from_numpy, "mxu": interop.mxu_from_numpy}


@pytest.mark.parametrize("kind", ["flat", "hbm", "hbm_np", "mxu"])
def test_pack_bit_equal(kind):
    """pack_clusters, pack_clusters_hbm (on tensors), pack_clusters_hbm_np
    and pack_clusters_mxu_np equal the JAX packs field for field, and
    interop turns the JAX pack into the same tensors."""
    jp, tp = _packs()[kind]
    conv = _FROM_NUMPY[kind](jp, "cpu")
    for f in _FIELDS[kind]:
        a = np.asarray(getattr(jp, f))
        for b in (getattr(tp, f), getattr(conv, f)):
            assert b.numpy().dtype == a.dtype and b.shape == a.shape, f
            np.testing.assert_array_equal(b.numpy().view(np.int32), a.view(np.int32), err_msg=f)
    assert tp.num_clusters == conv.num_clusters == int(jp.num_clusters) == 3


_KERNELS = {
    "flat": (jpc.intersect_pallas, tpc.intersect_pallas, lambda: tpc.LAUNCHES),
    "hbm": (jhbm.intersect_pallas_hbm, thbm.intersect_pallas_hbm, lambda: thbm.LAUNCHES),
    "mxu": (jmxu.intersect_pallas_mxu, tmxu.intersect_pallas_mxu, lambda: tmxu.LAUNCHES),
}


def _mt_terms(o, d, tv, dtype):
    """The Moller-Trumbore quantities of rays o, d [n,3] against triangles
    tv [n,3,3] in `dtype`, in the kernels' operation order: the terms of
    det and of the numerators of u, v and t."""
    o, d, tv = (np.asarray(x, dtype) for x in (o, d, tv))
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    tvec = o - tv[:, 0]

    def cross(a, b):
        return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                         a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                         a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)

    pv = cross(d, e2)
    qv = cross(tvec, e1)
    # [n, 3] terms each, summed x + y + z: det, u*det, v*det, t*det
    return e1 * pv, tvec * pv, d * qv, e2 * qv


def _mxu_terms(mc, o, d, prim, dtype):
    """The matrix form's ten terms F_q * G_q of det and of the numerators
    of u, v and t for each ray's hit triangle `prim`, in `dtype`."""
    order = mc.order.numpy().reshape(-1)
    pos = np.array([np.nonzero(order == p)[0][0] for p in prim])
    c, k = pos // tmxu.K, pos % tmxu.K
    g = mc.g_rows.numpy().reshape(-1, tmxu.NF, 4, tmxu.K)[c, :10, :, k].astype(dtype)
    o, d = np.asarray(o, dtype), np.asarray(d, dtype)
    op = o - mc.centers.numpy()[0:3, c // tmxu.SC].T.astype(dtype)
    f = np.stack([d[:, 0], d[:, 1], d[:, 2], d[:, 1] * op[:, 2] - d[:, 2] * op[:, 1],
                  d[:, 2] * op[:, 0] - d[:, 0] * op[:, 2], d[:, 0] * op[:, 1] - d[:, 1] * op[:, 0],
                  op[:, 0], op[:, 1], op[:, 2], np.ones_like(d[:, 0])], 1)
    terms = f[:, :, None] * g  # [n, 10, 4]: columns det | u | v | t
    return tuple(terms[:, :, i] for i in (0, 1, 2, 3))


def _evaluate(terms):
    """(t, u, v) from (det, u*det, v*det, t*det) terms, each summed in
    order and divided as the kernels do."""
    det, un, vn, tn = (np.cumsum(x, axis=1)[:, -1] for x in terms)  # sequential sums
    inv = det.dtype.type(1.0) / det
    return tn * inv, un * inv, vn * inv


def _kappas(terms64):
    """kappa of t, u and v (see the module docstring)."""
    det = np.abs(terms64[0].sum(1))
    k_det = np.abs(terms64[0]).sum(1) / det
    out = []
    for x in (terms64[3], terms64[1], terms64[2]):
        out.append(np.abs(x).sum(1) / det + k_det * np.abs(x.sum(1) / det))
    return out


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", ["flat", "hbm", "mxu"])
def test_plain_matches_interpret(kind, any_hit):
    tris, o, d = _scene()
    jfn, tfn, launches = _KERNELS[kind]
    jp, tp = _packs()[kind]
    before = launches()
    ref = jfn(jp, jnp.asarray(o), jnp.asarray(d), 1e-3, any_hit=any_hit, interpret=True)
    got = tfn(tp, torch.from_numpy(o), torch.from_numpy(d), 1e-3, any_hit=any_hit)
    assert launches() == before  # CPU tensors never reach the CUDA kernel
    r_h, g_h = np.asarray(ref[4]), got[4].numpy()
    np.testing.assert_array_equal(g_h, r_h)
    assert 80 < int(g_h.sum()) < N_RAY
    if any_hit:
        return
    r_t, r_p, r_u, r_v = (np.asarray(x)[r_h] for x in ref[:4])
    g_t, g_p, g_u, g_v = (x.numpy()[g_h] for x in got[:4])
    assert (g_p == r_p).all()
    assert np.isinf(got[0].numpy()[~g_h]).all() and (got[1].numpy()[~g_h] == -1).all()
    if kind == "mxu":
        terms = functools.partial(_mxu_terms, tp, o[g_h], d[g_h], g_p)
    else:
        terms = functools.partial(_mt_terms, o[g_h], d[g_h], tris[g_p])
    for name, a, b, kappa in zip("tuv", (g_t, g_u, g_v), (r_t, r_u, r_v),
                                 _kappas(terms(np.float64))):
        err = np.abs(a.astype(np.float64) - b)
        assert (err <= ULPS * EPS32 * kappa).all(), (name, float((err / (EPS32 * kappa)).max()))
    # the port's arithmetic, to the bit
    for a, b in zip((g_t, g_u, g_v), _evaluate(terms(np.float32))):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("kind", ["flat", "hbm", "mxu"])
def test_zero_tmax_lanes_miss(kind):
    """A ray with tmax 0 (the TPU wrapper's padding lane) misses at once,
    and a per-ray tmax cuts hits beyond it, as in brute force."""
    from henjou_torch.accel.bruteforce import intersect_bruteforce

    tris, o, d = _scene()
    _, tfn, _ = _KERNELS[kind]
    _, tp = _packs()[kind]
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tmax = torch.where(torch.arange(N_RAY) % 3 == 0, 0.0, 6.0)
    got = tfn(tp, to, td, 1e-3, tmax)
    ref = intersect_bruteforce(torch.from_numpy(tris), to, td, 1e-3, tmax)
    assert not got[4][tmax == 0].any()
    assert (got[4] != ref[4]).sum() <= 1
    assert int(got[4].sum()) > 30


@pytest.mark.parametrize("kind", ["flat", "hbm", "mxu", "binned"])
def test_plain_counts_cluster_visits(kind):
    """VISITS, the work chip_smoke.py's bound counts, grows by the (ray,
    cluster) pairs a plain version tests triangles for: none for rays with
    tmax 0, at least one per hit ray and at most rays x cluster slots (a
    pack's padding clusters have inverted boxes, which pass a slab test,
    as in the JAX packs)."""
    from henjou_torch.accel import pallas_binned as tpb

    tris, o, d = _scene()
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    if kind == "binned":
        mod, fn, pack = tpb, tpb.intersect_binned, tpb.pack_binned_np(tris, "cpu")
    else:
        mod = {"flat": tpc, "hbm": thbm, "mxu": tmxu}[kind]
        fn, pack = _KERNELS[kind][1], _packs()[kind][1]
    mod.VISITS = 0
    fn(pack, to, td, 1e-3, 0.0)
    assert mod.VISITS == 0
    hit = fn(pack, to, td, 1e-3)[4]
    assert 0 < int(hit.sum()) <= mod.VISITS <= N_RAY * pack.aabb.shape[1]
