"""The port's denoiser (henjou_torch/post/denoise.py) and the camera's
probe and reprojection functions against the JAX package, on the CPU.

Every function of henjou_tpu/post/denoise.py runs on the same numpy inputs
(made from a seed) in both packages. Tolerance: rtol 1e-4, atol 1e-5 on
outputs of order 1 (XLA and torch differ in exp/sqrt rounding and in
fusion; the observed maximum is far below, see CHANGES.md). Reprojection
coordinates are drawn with a fractional part in [0.05, 0.95], away from
texel boundaries where an ulp would change the floor. The upscalers run
at an odd size (9x7) so both edge rules are exercised. The second half
ports the non-slow cases of tests/test_denoise_var.py and
tests/test_temporal_reproject.py to the port's functions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from henjou_torch.post import denoise as td
from henjou_torch.runtime import camera as tcam
from henjou_tpu.post import denoise as jd
from henjou_tpu.runtime import camera as jcam

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
H, W = 12, 17


def _close(port, ref, rtol=RTOL, atol=ATOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def _aovs(seed, h=H, w=W):
    """color (order 1, a few HDR pixels), albedo (some near zero, to hit
    the demodulation guard), unit normals in patches, variance, counts."""
    rng = np.random.default_rng(seed)
    color = rng.random((h, w, 3), dtype=np.float32) * 1.5
    color[rng.random((h, w)) < 0.05] *= 4.0
    albedo = rng.random((h, w, 3), dtype=np.float32)
    albedo[rng.random((h, w)) < 0.1] = 0.0
    albedo[rng.random((h, w, 3)) < 0.05] = 5e-4
    n = np.repeat(np.repeat(rng.normal(size=(h // 3 + 1, w // 3 + 1, 3)), 3, 0), 3, 1)[:h, :w]
    n = n + 0.05 * rng.normal(size=(h, w, 3))
    normal = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    variance = (rng.random((h, w), dtype=np.float32) * 0.02).astype(np.float32)
    count = rng.integers(1, 9, (h, w)).astype(np.float32)
    return color, albedo, normal, variance, count


def _reprojection(seed, h=H, w=W, off=1.5):
    """Continuous history coordinates near the identity, fractional parts
    in [0.05, 0.95], a few off screen, and a validity mask."""
    rng = np.random.default_rng(seed)
    iy, ix = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    fx = rng.uniform(0.05, 0.95, (h, w))
    fy = rng.uniform(0.05, 0.95, (h, w))
    px = (ix + rng.integers(-1, 2, (h, w)) + fx + 0.5).astype(np.float32)
    py = (iy + rng.integers(-1, 2, (h, w)) + fy + 0.5).astype(np.float32)
    px[0, :3] = -off - 0.3  # off screen
    valid = rng.random((h, w)) > 0.15
    return px, py, valid


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------- every function against the JAX package ----------------


@pytest.mark.parametrize("dy,dx", [(0, 0), (-2, 1), (3, -4), (8, -16), (-20, 20)])
def test_shift2d_and_pad_match_jax(dy, dx):
    img = _aovs(0)[0]
    _close(td._shift2d(*_t(img), dy, dx), jd._shift2d(jnp.asarray(img), dy, dx), 0, 0)
    p = max(abs(dy), abs(dx))
    tap = td._tap(td._pad_edge(torch.from_numpy(img), p), p, dy, dx, H, W)
    _close(tap, jd._shift2d(jnp.asarray(img), dy, dx), 0, 0)


# The JAX filters compile per shape and static argument (~10 s each on the
# CPU), so the cases share one shape and vary only traced arguments where
# they can.


def test_denoise_atrous_matches_jax():
    color, albedo, normal, _, _ = _aovs(1)
    _close(td.denoise_atrous(*_t(color, albedo, normal)),
           jd.denoise_atrous(*_j(color, albedo, normal)))
    kw = dict(sigma_color=0.5, sigma_albedo=0.3, sigma_normal=0.5)
    _close(td.denoise_atrous(*_t(color, albedo, normal), **kw),
           jd.denoise_atrous(*_j(color, albedo, normal), **kw))


@pytest.mark.parametrize("demodulate,pairwise", [(True, False), (False, True)])
def test_denoise_atrous_var_matches_jax(demodulate, pairwise):
    color, albedo, normal, variance, _ = _aovs(2)
    kw = dict(demodulate=demodulate, pairwise=pairwise)
    _close(td.denoise_atrous_var(*_t(color, albedo, normal, variance), **kw),
           jd.denoise_atrous_var(*_j(color, albedo, normal, variance), **kw))


def test_denoise_atrous_var_keywords_match_jax():
    color, albedo, normal, variance, _ = _aovs(3)
    kw = dict(sigma_lum=4.0, sigma_albedo=0.3, sigma_normal=0.5)
    _close(td.denoise_atrous_var(*_t(color, albedo, normal, variance), **kw),
           jd.denoise_atrous_var(*_j(color, albedo, normal, variance), **kw))


def test_maxpool3_and_box3_match_jax():
    color, _, _, variance, _ = _aovs(4)
    _close(td._maxpool3(*_t(color)), jd._maxpool3(jnp.asarray(color)), 0, 0)
    _close(td._box3(*_t(variance)), jd._box3(jnp.asarray(variance)))


def test_denoise_temporal_matches_jax():
    color, albedo, normal, _, _ = _aovs(5)
    prev = _aovs(6)
    args = (color, albedo, normal, prev[0], prev[1], prev[2])
    _close(td.denoise_temporal(*_t(*args)), jd.denoise_temporal(*_j(*args)))
    spatial = _aovs(7)[0]
    _close(td.denoise_temporal(*_t(*args), alpha=0.5, spatial=torch.from_numpy(spatial)),
           jd.denoise_temporal(*_j(*args), alpha=0.5, spatial=jnp.asarray(spatial)))


def test_bilinear_sample_matches_jax():
    img = _aovs(8)[0]
    px, py, _ = _reprojection(8)
    out, inb = td._bilinear_sample(*_t(img, px, py))
    jout, jinb = jd._bilinear_sample(*_j(img, px, py))
    _close(out, jout)
    np.testing.assert_array_equal(inb.numpy(), np.asarray(jinb))
    assert not inb.all() and inb.any()


def test_denoise_temporal_reprojected_matches_jax():
    color, albedo, normal, _, _ = _aovs(9)
    prev = _aovs(10)
    px, py, valid = _reprojection(9)
    args = (color, albedo, normal, prev[0], prev[1], prev[2], px, py, valid)
    # without `spatial` both filter with denoise_atrous first; the JAX side
    # is given that image, so its jitted body compiles without the filter
    _close(td.denoise_temporal_reprojected(*_t(*args)),
           jd.denoise_temporal_reprojected(
               *_j(*args), spatial=jd.denoise_atrous(*_j(color, albedo, normal))))
    spatial = _aovs(11)[0]
    _close(td.denoise_temporal_reprojected(*_t(*args), spatial=torch.from_numpy(spatial)),
           jd.denoise_temporal_reprojected(*_j(*args), spatial=jnp.asarray(spatial)))


@pytest.mark.parametrize("cap", [4.0, 1.5])
def test_temporal_accumulate_matches_jax(cap):
    color, albedo, normal, variance, count = _aovs(12)
    pc, pa, pn, pv, pcount = _aovs(13)
    # history close to the current frame on most pixels, so the gates vary
    pc = (color + 0.1 * (pc - 0.75)).astype(np.float32)
    pa = np.where(np.random.default_rng(14).random((H, W, 1)) < 0.7, albedo, pa)
    px, py, valid = _reprojection(12)
    args = (color, variance, count, albedo, normal, pc, pv, pcount * 3, pa, pn, px, py, valid)
    got = td.temporal_accumulate(*_t(*args), cap=cap)
    want = jd.temporal_accumulate(*_j(*args), cap=cap)
    for g, w in zip(got, want):
        _close(g, w)
    assert float(got[2].max()) > float(got[2].min())  # some history taken, some not


@pytest.mark.parametrize("hi", [(14, 18), (15, 19)])
def test_upscale2x_guided_matches_jax(hi):
    """Half size 9x7 (odd), full size twice it, or the odd full size a
    DenoiseUpScale2X render of 19x15 gives (rendered at 9x7)."""
    img, alb_lo, nrm_lo, _, _ = _aovs(15, 7, 9)
    _, alb_hi, nrm_hi, _, _ = _aovs(16, *hi)
    # the full-res guides agree with the half-res ones over most pixels
    alb_hi[: hi[0] // 2 * 2 : 2, : hi[1] // 2 * 2 : 2] = alb_lo[: hi[0] // 2, : hi[1] // 2]
    args = (img, alb_lo, nrm_lo, alb_hi, nrm_hi)
    out = td.upscale2x_guided(*_t(*args))
    assert out.shape == (*hi, 3)
    _close(out, jd.upscale2x_guided(*_j(*args)))
    _close(td.upscale2x_guided(*_t(*args), sigma_albedo=0.3, sigma_normal=0.5),
           jd.upscale2x_guided(*_j(*args), sigma_albedo=0.3, sigma_normal=0.5))


def test_upscale2x_matches_jax_at_odd_size():
    img = _aovs(17, 7, 9)[0]
    out = td.upscale2x(torch.from_numpy(img))
    assert out.shape == (14, 18, 3)
    _close(out, jd.upscale2x(jnp.asarray(img)))
    # the first row and column extrapolate with weight -0.25 (clipped y0/x0)
    np.testing.assert_allclose(out[0, 0].numpy(),
                               1.25 * (1.25 * img[0, 0] - 0.25 * img[0, 1])
                               - 0.25 * (1.25 * img[1, 0] - 0.25 * img[1, 1]), rtol=1e-5)


def _pitched_cams():
    d = np.asarray([0.0, -0.27, 0.96], np.float32)
    d /= np.linalg.norm(d)
    right = np.cross(d, [0.0, 1.0, 0.0])
    skewed = dict(up=[0.0, 1.0, 0.0], right=right)
    return [(([1.0, 2.5, -4.0], [0.2, 0.4, 1.0], np.pi / 4), {}),
            (([0.0, 6.0, -16.5], d, np.radians(40.0)), skewed)]


@pytest.mark.parametrize("case", range(2))
def test_camera_rays_centers_and_projection_match_jax(case):
    args, kw = _pitched_cams()[case]
    jc = jcam.make_camera(*args, **kw)
    tc = tcam.make_camera(*args, "cpu", **kw)
    w, h = 24, 14
    o, d = tcam.camera_rays_centers(tc, w, h)
    jo, jdir = jcam.camera_rays_centers(jc, w, h)
    _close(o, jo, 0, 0)
    _close(d, jdir, 1e-6, 1e-6)
    rng = np.random.default_rng(case)
    pts = (rng.normal(size=(300, 3)) * 6 + np.asarray(args[0])).astype(np.float32)
    got = tcam.project_to_pixel(tc, torch.from_numpy(pts), w, h)
    want = jcam.project_to_pixel(jc, jnp.asarray(pts), w, h)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    ok = got[2].numpy()
    for g, wv in zip(got[:2], want[:2]):
        # a point near the camera plane magnifies ulps: relative limit
        np.testing.assert_allclose(g.numpy()[ok], np.asarray(wv)[ok], rtol=1e-4, atol=1e-3)


# ---------------- the JAX package's cases, on the port ----------------


def _synthetic():
    """Piecewise-constant truth and spatially varying noise whose level the
    variance map reports exactly (tests/test_denoise_var.py)."""
    rng = np.random.default_rng(5)
    h = w = 96
    truth = np.zeros((h, w, 3), np.float32)
    truth[:, : w // 2] = [0.2, 0.4, 0.7]
    truth[:, w // 2:] = [0.8, 0.5, 0.2]
    albedo = truth.copy()
    normal = np.zeros((h, w, 3), np.float32)
    normal[..., 2] = 1.0
    sigma = np.where(np.arange(h)[:, None] < h // 2, 0.02, 0.35).astype(np.float32)
    noisy = truth + rng.normal(size=(h, w, 3)).astype(np.float32) * sigma[..., None]
    var = (sigma ** 2).repeat(w, axis=1).astype(np.float32)
    return truth, noisy, albedo, normal, var


def test_variance_guided_preserves_edges_when_converged():
    truth, _, albedo, normal, _ = _synthetic()
    out = td.denoise_atrous_var(*_t(truth, albedo, normal), torch.zeros(truth.shape[:2]))
    np.testing.assert_allclose(out.numpy(), truth, atol=5e-3)


def test_pairwise_edge_stop_uniform_noop():
    """On a uniform noise floor one pairwise iteration equals the one-sided
    form (demodulate=False); on the heteroscedastic floor it still
    denoises."""
    truth, noisy, albedo, normal, var = _synthetic()
    uni = torch.full(var.shape, 0.04)
    col, alb, nrm = _t(noisy, albedo, normal)
    one = td.denoise_atrous_var(col, alb, nrm, uni, iterations=1, demodulate=False)
    two = td.denoise_atrous_var(col, alb, nrm, uni, iterations=1, demodulate=False,
                                pairwise=True)
    np.testing.assert_allclose(one.numpy(), two.numpy(), atol=1e-6)
    two = td.denoise_atrous_var(col, alb, nrm, torch.from_numpy(var), pairwise=True).numpy()
    e2 = np.sqrt(np.mean((two - truth) ** 2))
    e_noisy = np.sqrt(np.mean((noisy - truth) ** 2))
    assert e2 < 0.5 * e_noisy, (e2, e_noisy)


def test_guided_upscale_reconstructs_edges():
    fh, fw = 32, 32
    xs = np.arange(fw)
    alb_full = np.where((xs < fw // 2)[None, :, None], [[[0.8, 0.1, 0.1]]],
                        [[[0.1, 0.1, 0.8]]]).astype(np.float32) * np.ones((fh, 1, 1), np.float32)
    nrm_full = np.tile([0.0, 0.0, 1.0], (fh, fw, 1)).astype(np.float32)
    truth = alb_full * 0.5

    def half(a):
        return a.reshape(fh // 2, 2, fw // 2, 2, 3).mean(axis=(1, 3))

    bil = td.upscale2x(torch.from_numpy(half(truth))).numpy()
    gd = td.upscale2x_guided(*_t(half(truth), half(alb_full), half(nrm_full), alb_full,
                                 nrm_full)).numpy()
    err_b = np.sqrt(((bil - truth) ** 2).mean())
    err_g = np.sqrt(((gd - truth) ** 2).mean())
    assert err_g < 0.5 * err_b, (err_g, err_b)
    np.testing.assert_allclose(gd[:, :8], truth[:, :8], atol=1e-5)


def _cam(pos, look, fov=np.pi / 4):
    d = np.asarray(look, np.float32) - np.asarray(pos, np.float32)
    return tcam.make_camera(pos, d / np.linalg.norm(d), fov, "cpu")


@pytest.mark.parametrize("skewed", [False, True])
def test_project_to_pixel_inverts_raygen(skewed):
    """Points along pixel-centre rays project back to those centres, for a
    pitched camera and for the reference's non-orthogonal basis."""
    if skewed:
        d = np.asarray([0.0, -0.27, 0.96], np.float32)
        d /= np.linalg.norm(d)
        cam = tcam.make_camera([0.0, 6.0, -16.5], d, np.radians(40.0), "cpu",
                               up=[0.0, 1.0, 0.0], right=np.cross(d, [0.0, 1.0, 0.0]))
        assert abs(float(cam.up @ cam.direction)) > 0.1
        w, h, t_max = 48, 28, 30.0
    else:
        cam = _cam([1.0, 2.5, -4.0], [0.2, 0.4, 1.0])
        w, h, t_max = 24, 16, 12.0
    o, d = tcam.camera_rays_centers(cam, w, h)
    ts = torch.linspace(0.5, t_max, w * h)[:, None]
    px, py, valid = tcam.project_to_pixel(cam, o + ts * d, w, h)
    iy, ix = np.divmod(np.arange(w * h), w)
    assert bool(valid.all())
    np.testing.assert_allclose(px.numpy(), ix + 0.5, atol=2e-3)
    np.testing.assert_allclose(py.numpy(), iy + 0.5, atol=2e-3)


def test_project_behind_camera_invalid():
    cam = _cam([0.0, 0.0, 0.0], [0.0, 0.0, 1.0])
    _, _, valid = tcam.project_to_pixel(cam, torch.tensor([[0.0, 0.0, -5.0], [0.0, 0.0, 5.0]]),
                                        16, 16)
    assert not bool(valid[0]) and bool(valid[1])


def _centres(h, w):
    return torch.meshgrid(torch.arange(h, dtype=torch.float32) + 0.5,
                          torch.arange(w, dtype=torch.float32) + 0.5, indexing="ij")


def test_bilinear_sample_identity_and_bounds():
    img = torch.from_numpy(np.random.default_rng(3).random((8, 12, 3), dtype=np.float32))
    yy, xx = _centres(8, 12)
    out, inb = td._bilinear_sample(img, xx, yy)
    np.testing.assert_allclose(out.numpy(), img.numpy(), atol=1e-6)
    assert bool(inb.all())
    _, inb2 = td._bilinear_sample(img, xx - 100.0, yy)
    assert not bool(inb2.any())


def test_reprojection_beats_blend_under_camera_motion():
    """A textured plane seen by a trucking camera: the previous frame warped
    through the previous camera aligns far better than unwarped."""
    w, h = 64, 48

    def plane_image(cam):
        o, d = tcam.camera_rays_centers(cam, w, h)
        t = -o[:, 1] / d[:, 1]
        p = o + t[:, None] * d
        col = torch.stack([0.5 + 0.5 * torch.sin(1.3 * p[:, 0]),
                           0.5 + 0.5 * torch.cos(0.9 * p[:, 2]),
                           0.5 + 0.5 * torch.sin(0.7 * (p[:, 0] + p[:, 2]))], dim=1)
        return p.reshape(h, w, 3), col.reshape(h, w, 3), (t > 0).reshape(h, w)

    cam_prev = _cam([0.0, 3.0, -6.0], [0.0, 0.0, 0.0])
    cam_cur = _cam([0.6, 3.0, -6.0], [0.6, 0.0, 0.0])
    _, img_prev, _ = plane_image(cam_prev)
    pos_cur, img_cur, hitm = plane_image(cam_cur)
    px, py, infront = tcam.project_to_pixel(cam_prev, pos_cur.reshape(-1, 3), w, h)
    warped, inb = td._bilinear_sample(img_prev, px.reshape(h, w), py.reshape(h, w))
    ok = (inb[..., 0] & infront.reshape(h, w) & hitm).numpy()
    err_warped = np.abs((warped - img_cur).numpy())[ok].mean()
    err_unwarped = np.abs((img_prev - img_cur).numpy())[ok].mean()
    assert err_warped < 0.02, err_warped
    assert err_warped < err_unwarped * 0.25, (err_warped, err_unwarped)


def test_denoise_temporal_reprojected_rejects_disocclusion():
    """Invalid reprojection gives zero history weight (the spatial filter);
    valid reprojection takes poisoned history only up to the 3x3 clamp.
    The JAX package marks this case slow; at 16x16 it takes well under a
    second here."""
    h, w = 16, 16
    rng = np.random.default_rng(11)
    color = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32))
    albedo = torch.full((h, w, 3), 0.5)
    normal = torch.zeros((h, w, 3))
    normal[..., 2] = 1.0
    prev = torch.full((h, w, 3), 7.0)
    yy, xx = _centres(h, w)
    out = td.denoise_temporal_reprojected(color, albedo, normal, prev, albedo, normal, xx, yy,
                                          torch.zeros((h, w), dtype=torch.bool))
    spatial = td.denoise_atrous(color, albedo, normal)
    np.testing.assert_allclose(out.numpy(), spatial.numpy(), atol=1e-6)
    out2 = td.denoise_temporal_reprojected(color, albedo, normal, prev, albedo, normal, xx, yy,
                                           torch.ones((h, w), dtype=torch.bool))
    assert float((out2 - spatial).abs().max()) > 0.1
    assert float((out2 - td._maxpool3(spatial)).max()) <= 1e-6


def test_chunked_closest_hit_matches_single_call_and_jax():
    """The probes' chunked trace (pad, per-chunk closest hit, strip) equals
    one call on a ray count that is not a multiple of the chunk, and the
    JAX package's chunked trace."""
    import jax

    from henjou_torch.integrator import payload as tpay
    from henjou_torch.runtime.renderer import _chunked_closest_hit
    from henjou_torch.scene import scenedata as tsd
    from henjou_torch.scene.testscenes import cornell_box_scene
    from henjou_tpu.integrator import payload as jpay
    from henjou_tpu.runtime.renderer import _chunked_closest_hit as j_chunked
    from henjou_tpu.scene import scenedata as jsd
    from henjou_tpu.scene.testscenes import cornell_box_scene as j_cornell

    frame = tsd.build_frame_scene(tsd.build_device_scene(cornell_box_scene(), "cpu"))
    sky = tpay.Sky(constant_color=torch.zeros(3), intensity=torch.tensor(1.0))
    rng = np.random.default_rng(3)
    r = 2500
    o = rng.uniform(-1, 1, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    one = _chunked_closest_hit(frame, sky, *_t(o, d), None)
    chunked = _chunked_closest_hit(frame, sky, *_t(o, d), None, chunk=1024)
    for a, b in zip(one, chunked):
        assert torch.equal(a, b)
    jframe = jax.jit(jsd.build_frame_scene)(jsd.build_device_scene(j_cornell()), None, None)
    jsky = jpay.Sky(constant_color=jnp.zeros(3), intensity=jnp.asarray(1.0))
    jhit = j_chunked(jframe, jsky, *_j(o, d), None, chunk=1024)
    np.testing.assert_array_equal(chunked.is_hit.numpy(), np.asarray(jhit.is_hit))
    for f in ("position", "normal", "basecolor"):
        _close(getattr(chunked, f), getattr(jhit, f))


def _identity_history(h, w, seed):
    rng = np.random.default_rng(seed)
    albedo = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32))
    normal = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32))
    yy, xx = _centres(h, w)
    return albedo, normal, xx, yy


def test_temporal_accumulate_merges_counts_and_variance():
    h, w = 8, 12
    albedo, normal, xx, yy = _identity_history(h, w, 7)
    cur = torch.full((h, w, 3), 2.0)
    var = torch.full((h, w), 0.1)
    pvar = torch.full((h, w), 0.05)
    cnt = torch.full((h, w), 8.0)
    valid = torch.ones((h, w), dtype=torch.bool)
    merged, var_m, n_eff = td.temporal_accumulate(cur, var, cnt, albedo, normal, cur, pvar,
                                                  cnt, albedo, normal, xx, yy, valid)
    np.testing.assert_allclose(merged.numpy(), 2.0, atol=1e-5)
    np.testing.assert_allclose(n_eff.numpy(), 16.0, atol=1e-4)
    np.testing.assert_allclose(var_m.numpy(), 0.0375, atol=1e-5)
    _, _, n_eff2 = td.temporal_accumulate(cur, var, cnt, albedo, normal, cur, pvar,
                                          torch.full((h, w), 1000.0), albedo, normal, xx, yy,
                                          valid)
    np.testing.assert_allclose(n_eff2.numpy(), 40.0, atol=1e-3)
    merged3, var3, n3 = td.temporal_accumulate(cur, var, cnt, albedo, normal, cur + 5.0, pvar,
                                               cnt, albedo, normal, xx, yy, ~valid)
    np.testing.assert_allclose(merged3.numpy(), 2.0, atol=1e-5)
    np.testing.assert_allclose(n3.numpy(), 8.0, atol=1e-4)
    np.testing.assert_allclose(var3.numpy(), 0.1, atol=1e-5)


def test_temporal_accumulate_neighborhood_clamp():
    h, w = 8, 8
    albedo, normal, xx, yy = _identity_history(h, w, 11)
    cur = torch.from_numpy(np.random.default_rng(12).random((h, w, 3), dtype=np.float32))
    hist = torch.full((h, w, 3), 50.0)
    var = torch.full((h, w), 0.1)
    cnt = torch.full((h, w), 8.0)
    valid = torch.ones((h, w), dtype=torch.bool)
    merged, _, _ = td.temporal_accumulate(cur, var, cnt, albedo, normal, hist, var, cnt,
                                          albedo, normal, xx, yy, valid)
    bound = td._maxpool3(cur) + 3.0 * torch.sqrt(var)[..., None]
    assert float((merged - bound).max()) <= 1e-5
    merged0, _, _ = td.temporal_accumulate(cur, torch.zeros((h, w)), cnt, albedo, normal, hist,
                                           var, cnt, albedo, normal, xx, yy, valid)
    assert float((merged0 - td._maxpool3(cur)).max()) <= 1e-5
