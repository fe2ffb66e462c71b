"""Adaptive sample allocation of the port against the JAX package's
(tests/test_adaptive.py).

1. `_adaptive_allocation` exactly equal to JAX's (the same numpy code) on
   sums drawn with numpy from a seed, both metrics, and its deficit,
   budget and clip properties.
2. The wavefront engine's list mode (`sample_counts`, `sample_base`)
   against JAX's `wavefront_render` on the sphere gallery, with the limits
   of tests/test_torch_wavefront.py (per-pixel RMSE of the means <= 5e-3,
   counts and traces equal); flat counts reproduce the uniform film and a
   two-pass split with `sample_base` sums to the one-pass film (rtol 1e-5,
   atol 1e-6, JAX's limits).
3. The Renderer's adaptive loop (a uniform warm-up batch, then
   deficit-based counts per chunk) against JAX's on the Cornell box:
   budget totals equal, per-pixel counts within 1 (a floor() tie can move
   by an ulp of the variance estimate), images within 1e-3 RMSE.
4. The masked engine ignores ``adaptive`` and ``light_ris``, as JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from henjou_torch.bsdf import dispatch as tdsp
from henjou_torch.integrator import payload as tpay
from henjou_torch.integrator.wavefront import wavefront_render as t_render
from henjou_torch.runtime import camera as tcam
from henjou_torch.runtime.options import RenderOption
from henjou_torch.runtime.renderer import Renderer, _adaptive_allocation
from henjou_torch.scene import scenedata as tsd
from henjou_torch.scene import testscenes as tscenes

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

CORNELL = dict(scene_sky_default=(0.0, 0.0, 0.0), camera_position=(0.0, 1.0, 3.5),
               camera_direction=(0.0, 0.0, -1.0))


def _sums(rng, npix):
    """(color sums, luminance-square sums, counts) of a film at uneven
    counts, with a high-variance block and an over-sampled one."""
    cnt = rng.integers(4, 64, npix).astype(np.float32)
    cnt[64:128] = 4096.0
    mu = rng.uniform(0.01, 3.0, npix).astype(np.float32)
    sig = rng.uniform(0.05, 0.5, npix).astype(np.float32)
    sig[:64] = 5.0
    color = (mu[:, None] * cnt[:, None] * rng.uniform(0.8, 1.2, (npix, 3))).astype(np.float32)
    m2 = ((sig * sig + mu * mu) * cnt).astype(np.float32)
    return color, m2, cnt


@pytest.mark.parametrize("metric", ["relstd", "std"])
@pytest.mark.parametrize("seed", [0, 1])
def test_allocation_equals_jax(metric, seed):
    from henjou_tpu.runtime.renderer import _adaptive_allocation as j_alloc

    rng = np.random.default_rng(seed)
    npix = 4096
    color, m2, cnt = _sums(rng, npix)
    for budget in (npix * 8, npix * 16 + 5):
        want = j_alloc(budget, color, m2, cnt, metric=metric)
        got = _adaptive_allocation(budget, color, m2, cnt, metric=metric)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    # everyone past target: the uniform fallback
    flat = np.full(16, 1.0, np.float32)
    assert np.array_equal(_adaptive_allocation(32, np.zeros((16, 3), np.float32), flat, flat),
                          j_alloc(32, np.zeros((16, 3), np.float32), flat, flat))


def test_allocation_is_deficit_based_and_bounded():
    npix, budget = 4096, 4096 * 16
    mu = np.full(npix, 0.5, np.float64)
    sig = np.full(npix, 0.1)
    sig[:64] = 5.0
    cnt = np.full(npix, 32.0)
    cnt[64:128] = 4096.0
    csum = np.stack([mu * cnt] * 3, 1)
    m2 = (sig * sig + mu * mu) * cnt
    a = _adaptive_allocation(budget, csum, m2, cnt)
    assert a.sum() <= budget and (a[64:128] == 0).all()
    assert a[:64].mean() > 4 * a[128:].mean()
    for _ in range(40):
        a = _adaptive_allocation(budget, np.stack([mu * cnt] * 3, 1),
                                 (sig * sig + mu * mu) * cnt, cnt)
        cnt = cnt + a
    assert cnt.max() / cnt.mean() < 12.0 and cnt[128:].min() / cnt.mean() > 0.2


def _gallery_counts():
    """Skewed counts summing to the 16x16, 2-spp budget, and per-pixel
    bases."""
    p = np.arange(256)
    counts = np.where(p % 16 < 8, 3, 1).astype(np.int32)
    counts[5] = 0
    counts[6] = 4
    return counts, (p % 3).astype(np.int32)


def test_engine_sample_counts_matches_jax():
    import jax.numpy as jnp

    from tests.test_torch_wavefront import TOL_RMSE, _jax, _port

    counts, base = _gallery_counts()
    jfilm = _jax("mis", sample_counts=jnp.asarray(counts), sample_base=jnp.asarray(base))
    tfilm = _port("mis", sample_counts=torch.from_numpy(counts),
                  sample_base=torch.from_numpy(base))
    assert np.array_equal(tfilm.count.numpy(), counts.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(jfilm.count), tfilm.count.numpy())
    assert int(tfilm.n_traces) == int(jfilm.n_traces)
    n = np.maximum(counts, 1)[:, None]
    rmse = float(np.sqrt(((np.asarray(jfilm.color) / n - tfilm.color.numpy() / n) ** 2).mean()))
    assert rmse <= TOL_RMSE, rmse


def _cornell_engine(spp, **kw):
    frame = tsd.build_frame_scene(tsd.build_device_scene(tscenes.cornell_box_scene(), "cpu"))
    cam = tcam.make_camera((0.0, 1.0, 3.5), (0.0, 0.0, -1.0), np.radians(45.0), "cpu")
    return t_render(frame, tpay.Sky(constant_color=torch.zeros(3), intensity=torch.tensor(0.0)),
                    cam, 16, 16, spp, tdsp.make_bsdf_sampler(None),
                    bsdf_eval=lambda h, wo, wi: tdsp.bsdf_eval(h, wo, wi, None),
                    bsdf_pdf=tdsp.bsdf_pdf, integrator="mis", seed=3, lanes=1 << 10, **kw)


def test_flat_counts_match_uniform_and_two_pass_continuation():
    spp = 4
    uni = _cornell_engine(spp)
    ada = _cornell_engine(spp, sample_counts=torch.full((256,), spp))
    np.testing.assert_allclose(ada.color.numpy(), uni.color.numpy(), rtol=1e-5, atol=1e-6)
    assert (ada.count == spp).all() and (uni.count == spp).all() and float(ada.m2.sum()) > 0
    counts = torch.where(torch.arange(256) % 16 < 8, 6, 2)
    one = _cornell_engine(spp + 2, sample_counts=counts)
    assert torch.equal(one.count, counts.float())
    c_a = torch.clamp(counts, max=3)
    p1 = _cornell_engine(spp + 2, sample_counts=c_a)
    p2 = _cornell_engine(spp + 2, sample_counts=counts - c_a, sample_base=c_a)
    np.testing.assert_allclose((p1.color + p2.color).numpy(), one.color.numpy(), rtol=1e-5,
                               atol=1e-6)


def _opt(**kw):
    base = dict(image_width=16, image_height=16, max_spp=16, spp_batch=8,
                integrator="pathtrace", **CORNELL)
    return RenderOption(**dict(base, **kw))


def test_renderer_adaptive_loop_matches_jax():
    from henjou_tpu.runtime import options as jopt
    from henjou_tpu.runtime.renderer import Renderer as JRenderer
    from henjou_tpu.scene import testscenes as jscenes

    jr = JRenderer(option=jopt.RenderOption(
        image_width=16, image_height=16, max_spp=16, spp_batch=8, integrator="pathtrace",
        adaptive=True, engine="wavefront", **CORNELL))
    jr.set_scene(jscenes.cornell_box_scene()).build()
    want = jr.render_frame(0)
    r = Renderer(option=_opt(adaptive=True, engine="wavefront"), device="cpu")
    r.set_scene(tscenes.cornell_box_scene()).build()
    got = r.render_frame(0)
    assert got["spp_done"] == want["spp_done"] == 16
    # the warm-up batch is uniform, the second is allocated by variance
    assert got["count"].min() >= 8 and got["count"].max() > got["count"].min()
    assert got["count"].sum() == want["count"].sum() <= 16 * 256
    assert np.abs(got["count"] - want["count"]).max() <= 1
    same = got["count"] == want["count"]
    assert same.mean() > 0.9
    rmse = float(np.sqrt(((got["color"][same] - want["color"][same]) ** 2).mean()))
    assert rmse <= 1e-3, rmse


def test_masked_engine_ignores_adaptive_and_ris():
    def render(**kw):
        r = Renderer(option=_opt(engine="masked", max_spp=2, spp_batch=2, **kw), device="cpu")
        r.set_scene(tscenes.cornell_box_scene()).build()
        return r.render_frame(0)

    plain = render()
    for kw in (dict(adaptive=True), dict(light_ris=8), dict(adaptive=True, light_ris=4,
                                                             integrator="mis")):
        out = render(**kw)
        ref = plain if "integrator" not in kw else render(integrator="mis")
        assert np.array_equal(out["color"], ref["color"]) and out["spp_done"] == 2, kw
    wave = Renderer(option=dataclasses.replace(_opt(engine="wavefront", max_spp=2, spp_batch=2),
                                               adaptive=True), device="cpu")
    wave.set_scene(tscenes.cornell_box_scene()).build()
    assert wave.render_frame(0)["count"].sum() == 2 * 256  # the warm-up batch is uniform
