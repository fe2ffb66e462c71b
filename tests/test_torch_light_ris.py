"""Resampled light selection (RIS, ``light_ris``) of the port against the
JAX package's (tests/test_light_ris.py).

1. `sample_light_ris` on the two-light Cornell box (tests/test_light_power.py)
   with the same CMJ states, m = 2, 4 and 8: the same candidate kept (its
   point within rtol 1e-4, its emission equal) on every lane but at most
   1e-3 of them (a running weight sum within an ulp of the draw can tip
   the pick either way), and there pdf_src and pdf_eff within rtol 1e-4
   (f32 sums in another order); valid equal, the same draws consumed.
2. The RIS identities on the port: E[1/pdf_eff] is the total light area,
   and on the target itself RIS agrees with the plain sampler in the mean
   at less than half its variance.
3. The wavefront engine with ``light_ris=8`` against JAX's
   `wavefront_render` on the sphere gallery, as tests/test_torch_wavefront.py
   compares the default engine (per-pixel RMSE of the means <= 5e-3,
   counts and traces equal).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from henjou_torch.sampling import light_sample as tls
from henjou_torch.sampling.cmj import make_cmj_state as t_state
from henjou_tpu.sampling import light_sample as jls
from henjou_tpu.sampling.cmj import make_cmj_state as j_state
from henjou_tpu.scene.scenedata import build_device_scene, build_frame_scene

from tests import torch_interop as interop
from tests.test_light_power import _two_light_scene

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

N = 1 << 15
RTOL = 1e-4
MAX_FLIPS = 1e-3
SHADE_POS, SHADE_N = (0.1, -0.3, -0.2), (0.0, 1.0, 0.0)


@functools.lru_cache(maxsize=None)
def _frames():
    jf = build_frame_scene(build_device_scene(_two_light_scene(8.0, 1.0)))
    return jf, interop.frame_scene_from_numpy(jf, "cpu")


def _inputs(n, seed):
    spp = np.arange(n, dtype=np.uint32) % 977
    pix = np.arange(n, dtype=np.uint32)
    jst = j_state(jnp.asarray(spp), jnp.asarray(pix), seed)
    tst = t_state(torch.from_numpy(spp.astype(np.int64)), torch.from_numpy(pix.astype(np.int64)),
                  seed)
    pos = np.broadcast_to(np.asarray(SHADE_POS, np.float32), (n, 3))
    nrm = np.broadcast_to(np.asarray(SHADE_N, np.float32), (n, 3))
    return (jst, jnp.asarray(pos), jnp.asarray(nrm)), (tst, torch.tensor(pos), torch.tensor(nrm))


@pytest.mark.parametrize("m", [2, 4, 8])
def test_sample_light_ris_matches_jax(m):
    jf, tf = _frames()
    (jst, jpos, jn), (tst, tpos, tn) = _inputs(N, seed=7 + m)
    want = jax.jit(lambda st: jls.sample_light_ris(jf, st, jpos, jn, m))(jst)
    got = tls.sample_light_ris(tf, tst, tpos, tn, m)
    w_pos, _, w_emi, w_eff, w_src, w_valid = (np.asarray(x) for x in want[:6])
    w_st = want[6]
    g_pos, _, g_emi, g_eff, g_src, g_valid, g_st = got
    # the same candidate kept: the same point on a light of the same emission
    same = ((np.abs(g_pos.numpy() - w_pos) <= 1e-6 + RTOL * np.abs(w_pos)).all(1)
            & (w_emi == g_emi.numpy()).all(1))
    assert (~same).mean() <= MAX_FLIPS, (~same).sum()
    np.testing.assert_allclose(g_src.numpy()[same], w_src[same], rtol=RTOL)
    np.testing.assert_allclose(g_eff.numpy()[same], w_eff[same], rtol=RTOL)
    assert np.array_equal(g_valid.numpy(), w_valid) and g_valid.all()
    # the same draws consumed: m candidates of two draws each, then the pick
    assert np.array_equal(g_st.depth.numpy(), np.asarray(w_st.depth).astype(np.int64))
    assert int(g_st.depth[0]) == 2 * m + 1


def _area(tf):
    tv = tf.tri_verts[tf.device.light_prim_ids].double()
    return float(0.5 * torch.linalg.norm(torch.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0],
                                                     dim=1), dim=1).sum())


def test_ris_pdf_eff_integrates_area():
    _, tf = _frames()
    for m in (2, 4):
        _, (tst, pos, nrm) = _inputs(N, seed=7 + m)
        _, _, _, pdf_eff, _, valid, _ = tls.sample_light_ris(tf, tst, pos, nrm, m)
        est = torch.where(valid, 1.0 / torch.clamp(pdf_eff, min=1e-30), 0.0).double()
        np.testing.assert_allclose(float(est.mean()), _area(tf), rtol=0.05)


def test_ris_matches_plain_mean_with_lower_variance():
    _, tf = _frames()
    p0, n0 = torch.tensor(SHADE_POS), torch.tensor(SHADE_N)

    def phat(lpos, lnrm, lemi):
        to_l = lpos - p0
        d2 = torch.clamp((to_l * to_l).sum(-1), min=1e-12)
        ldir = to_l / torch.sqrt(d2)[:, None]
        lum = lemi @ torch.tensor([0.2126, 0.7152, 0.0722])
        return lum * torch.abs(ldir @ n0) * torch.abs((-ldir * lnrm).sum(-1)) / d2

    _, (tst, pos, nrm) = _inputs(N, seed=11)
    lp, ln, le, pdf, _, _ = tls.sample_light(tf, tst)
    v_plain = (phat(lp, ln, le) / torch.clamp(pdf, min=1e-30)).double()
    _, (tst, pos, nrm) = _inputs(N, seed=12)
    lp, ln, le, pdf_eff, _, valid, _ = tls.sample_light_ris(tf, tst, pos, nrm, 4)
    v_ris = torch.where(valid, phat(lp, ln, le) / torch.clamp(pdf_eff, min=1e-30), 0.0).double()
    np.testing.assert_allclose(float(v_ris.mean()), float(v_plain.mean()), rtol=0.05)
    assert float(v_ris.var()) < 0.5 * float(v_plain.var())


def test_wavefront_light_ris_matches_jax():
    from tests.test_torch_wavefront import SPP, TOL_RMSE, _jax, _port

    jfilm = _jax("mis", light_ris=8)
    tfilm = _port("mis", light_ris=8)
    np.testing.assert_array_equal(np.asarray(jfilm.count), tfilm.count.numpy())
    assert int(tfilm.n_traces) == int(jfilm.n_traces)
    jc = np.asarray(jfilm.color) / SPP
    tc = tfilm.color.numpy() / SPP
    rmse = float(np.sqrt(((jc - tc) ** 2).mean()))
    assert rmse <= TOL_RMSE, rmse
    # RIS changes the draws: not the film of the plain sampler
    assert not torch.equal(tfilm.color, _port("mis").color)
