"""The port's Owen-scrambled Sobol sampler against the JAX package's
(tests/test_sobol.py).

1. `reverse_bits_u32`, `nested_uniform_scramble`, the dimension-2 value
   and `sobol_pair` bit-equal to JAX over 2^16 random u32 states drawn with
   numpy from a seed.
2. `cmj_2d` on states with the tag bit set on half the lanes, three draws
   deep: bit-equal to JAX's with its `set_sobol_enabled(True)` gate (the
   gate is restored in a `finally`), and with ``sobol=False`` bit-equal to
   JAX's with the gate off (tagged lanes then draw CMJ).
3. The sampler's own properties on the port (JAX's tests): range,
   stratification of every power-of-two prefix, decorrelation, a lower
   error than CMJ past 16 spp.
4. The masked integrators with tagged states against JAX's per lane on
   the Cornell box (rtol 1e-4, atol 1e-5 as tests/test_torch_masked.py),
   the masked engine against the wavefront two-sample form under Sobol,
   and the flag carried per renderer: a Sobol renderer leaves a later CMJ
   renderer's film bit-equal to a fresh one's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from henjou_torch.runtime.options import RenderOption
from henjou_torch.runtime.renderer import Renderer
from henjou_torch.sampling import cmj as tcmj
from henjou_torch.sampling import sobol as tsob
from henjou_torch.scene import testscenes as tscenes
from henjou_tpu.sampling import cmj as jcmj
from henjou_tpu.sampling import sobol as jsob

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

N_STATES = 1 << 16
FLAG = tcmj.SOBOL_SEED_FLAG


def _u32(rng, n, hi=1 << 32):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _j(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("name", ["reverse_bits_u32", "nested_uniform_scramble",
                                  "_sobol_dim2_u32", "sobol_pair"])
def test_sobol_bit_equal_to_jax(name):
    rng = np.random.default_rng(11)
    a, b, c = _u32(rng, N_STATES), _u32(rng, N_STATES), _u32(rng, N_STATES, 64)
    if name == "reverse_bits_u32":
        want, got = _j(jsob.reverse_bits_u32(jnp.asarray(a))), tsob.reverse_bits_u32(_t(a))
    elif name == "nested_uniform_scramble":
        want = _j(jsob.nested_uniform_scramble(jnp.asarray(a), jnp.asarray(b)))
        got = tsob.nested_uniform_scramble(_t(a), _t(b))
    elif name == "_sobol_dim2_u32":
        want, got = _j(jsob._sobol_dim2_u32(jnp.asarray(a))), tsob._sobol_dim2_u32(_t(a))
    else:
        fx, fy = jsob.sobol_pair(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                                 jnp.uint32(0x1234ABCD))
        gx, gy = tsob.sobol_pair(_t(a), _t(b), _t(c), 0x1234ABCD)
        assert gx.dtype == torch.float32 and np.array_equal(np.asarray(fx), gx.numpy())
        want, got = np.asarray(fy), gy
    assert np.array_equal(want, got.numpy())


def _states(rng):
    """(n_spp, pixel, per-lane seed) with the tag on half the lanes."""
    seeds = _u32(rng, N_STATES, 1 << 31) | np.where(np.arange(N_STATES) % 2 == 0, FLAG, 0)
    return _u32(rng, N_STATES, 4096), _u32(rng, N_STATES), seeds.astype(np.uint32)


@pytest.mark.parametrize("gate", [True, False])
def test_tagged_cmj_2d_bit_equal_to_jax(gate):
    n_spp, pix, seeds = _states(np.random.default_rng(5))
    jcmj.set_sobol_enabled(gate)
    try:
        jst = jcmj.make_cmj_state(jnp.asarray(n_spp), jnp.asarray(pix), jnp.asarray(seeds))
        tst = tcmj.make_cmj_state(_t(n_spp), _t(pix), _t(seeds), sobol=gate)
        for draw in range(3):
            want, jst = jcmj.cmj_2d(jst)
            got, tst = tcmj.cmj_2d(tst)
            assert np.array_equal(np.asarray(want), got.numpy()), draw
            assert tst.sobol == gate
    finally:
        jcmj.set_sobol_enabled(False)
    tagged = torch.from_numpy(seeds & FLAG != 0)
    cmj_only, _ = tcmj.cmj_2d(tcmj.make_cmj_state(_t(n_spp), _t(pix), _t(seeds)))
    first, _ = tcmj.cmj_2d(tcmj.make_cmj_state(_t(n_spp), _t(pix), _t(seeds), sobol=gate))
    # untagged lanes always draw CMJ; tagged ones only without the flag
    assert torch.equal(first[~tagged], cmj_only[~tagged])
    assert torch.equal(first[tagged], cmj_only[tagged]) == (not gate)


def _draws(n, pixel=7, seed=3, dims=1):
    st = tcmj.make_cmj_state(torch.arange(n), torch.full((n,), pixel), seed | FLAG, sobol=True)
    out = []
    for _ in range(dims):
        xy, st = tcmj.cmj_2d(st)
        out.append(xy.numpy())
    return np.stack(out, axis=1)


def test_sobol_range_and_prefix_stratification():
    xy = _draws(256)[:, 0, :]
    assert xy.min() >= 0.0 and xy.max() < 1.0
    for p in (4, 16, 64, 256):
        pre = xy[:p]
        for c in range(2):
            assert len(np.unique(np.floor(pre[:, c] * p).astype(int))) == p, (p, c)
        g = int(np.sqrt(p))
        cells = np.floor(pre[:, 0] * g).astype(int) * g + np.floor(pre[:, 1] * g).astype(int)
        assert len(np.unique(cells)) == p, p


def test_sobol_scramble_is_a_permutation_and_decorrelated():
    xs = torch.arange(4096, dtype=torch.int64) << 20
    ys = tsob.nested_uniform_scramble(xs, 0xABCD1234)
    assert len(torch.unique(ys >> 20)) == 4096
    a, b = _draws(512, pixel=1, dims=2), _draws(512, pixel=2, dims=2)
    for d in range(2):
        for c in range(2):
            assert abs(np.corrcoef(a[:, d, c], b[:, d, c])[0, 1]) < 0.12, (d, c)
    assert abs(np.corrcoef(a[:, 0, 0], a[:, 1, 0])[0, 1]) < 0.12


def test_sobol_beats_cmj_past_16_spp():
    n_pix, n_spp = 128, 64
    errs = {}
    for name, sobol in (("cmj", False), ("sobol", True)):
        st = tcmj.make_cmj_state(torch.arange(n_spp).repeat(n_pix),
                                 torch.arange(n_pix).repeat_interleave(n_spp),
                                 (7 | FLAG) if sobol else 7, sobol=sobol)
        xy, _ = tcmj.cmj_2d(st)
        f = (xy[:, 0] * xy[:, 1]).numpy().reshape(n_pix, n_spp)
        errs[name] = np.abs(f.mean(axis=1) - 0.25).mean()
    assert errs["sobol"] < 0.6 * errs["cmj"], errs


@pytest.mark.parametrize("integrator", ["pathtrace", "mis"])
def test_masked_integrator_sobol_matches_jax(integrator):
    """Tagged states through the masked integrators, per lane, against
    JAX's traced with its gate on (fresh jit wrappers, so the gate is read
    at this trace)."""
    from tests.test_torch_masked import ATOL, RTOL, _integrators, _lane_inputs

    jcmj.set_sobol_enabled(True)
    try:
        j_fn, t_fn = _integrators(integrator)
        for s in range(2):
            (o, d, jst), (to, td, tst) = _lane_inputs(s)
            jst = jst._replace(scramble=jst.scramble | jnp.uint32(FLAG))
            tst = tst._replace(scramble=tst.scramble | FLAG, sobol=True)
            want, got = j_fn(o, d, jst), t_fn(to, td, tst)
            np.testing.assert_allclose(got.lte.numpy(), np.asarray(want.lte), rtol=RTOL,
                                       atol=ATOL, err_msg=f"spp {s}")
            assert int(got.n_traces) == int(np.asarray(want.n_traces))
    finally:
        jcmj.set_sobol_enabled(False)
    # the tagged stream is not the CMJ one
    _, (to, td, tst) = _lane_inputs(0)
    tagged = tst._replace(scramble=tst.scramble | FLAG, sobol=True)
    assert not torch.equal(t_fn(to, td, tst).lte, t_fn(to, td, tagged).lte)


def _cornell(engine, sampler, size=8, spp=4, **kw):
    opt = RenderOption(image_width=size, image_height=size, max_spp=spp, spp_batch=spp,
                       engine=engine, mis_mode="ref", sampler=sampler,
                       camera_position=(0.0, 0.0, -4.5), camera_direction=(0.0, 0.0, 1.0),
                       scene_sky_default=(0.0, 0.0, 0.0), **kw)
    r = Renderer(option=opt, device="cpu")
    r.set_scene(tscenes.cornell_box_scene())
    return r.build()


def test_masked_sobol_matches_wavefront_ref():
    got = {e: _cornell(e, "sobol").render_frame(0) for e in ("masked", "wavefront")}
    np.testing.assert_allclose(got["masked"]["color"], got["wavefront"]["color"],
                               rtol=1e-4, atol=1e-5)
    assert got["masked"]["n_traces"] == got["wavefront"]["n_traces"]
    cmj = _cornell("masked", "cmj").render_frame(0)
    assert not np.array_equal(cmj["color"], got["masked"]["color"])


def test_sobol_choice_stays_with_its_renderer():
    """The JAX package's gate is process-wide; the port's flag rides each
    renderer's states: a CMJ renderer made after a Sobol one renders
    exactly what a fresh CMJ renderer does."""
    fresh = _cornell("wavefront", "cmj").render_frame(0)["color"]
    sob = _cornell("wavefront", "sobol")
    sob_film = sob.render_frame(0)["color"]
    after = _cornell("wavefront", "cmj").render_frame(0)["color"]
    assert np.array_equal(after, fresh) and not np.array_equal(sob_film, fresh)
    assert sob._frame_seed(1) & FLAG and not _cornell("wavefront", "cmj")._frame_seed(1) & FLAG
    sob.option = dataclasses.replace(sob.option, seed=0xFFFFFFFF)
    assert sob._frame_seed(1) == FLAG  # the low bits wrap, the tag stays
