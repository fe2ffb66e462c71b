"""Port parity: the CMJ sampler (bit-equal) and the camera (to 1e-6); the
draw wrapper's routing on the CPU: a CPU state takes the torch code and
launches nothing, the draw counters record under a profiler, and the CUDA
wrapper refuses a state whose fields it cannot take before any launch
(tests/test_torch_cuda.py holds the kernel against the torch code)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from henjou_torch.runtime import camera as tcam
from henjou_torch.sampling import cmj as tcmj
from henjou_torch.utils import timer
from henjou_tpu.runtime import camera as jcam
from henjou_tpu.sampling import cmj as jcmj

from tests import torch_interop as interop

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)


def _u32(rng, n, hi=2**32):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _states(spp, pix, depth, seed):
    js = jcmj.make_cmj_state(jnp.asarray(spp), jnp.asarray(pix), seed)
    js = js._replace(depth=jnp.asarray(depth))
    ts = tcmj.make_cmj_state(
        torch.from_numpy(spp.astype(np.int64)), torch.from_numpy(pix.astype(np.int64)), seed
    )
    ts = ts._replace(depth=torch.from_numpy(depth.astype(np.int64)))
    return js, ts


def _assert_bits(a, b):
    a = np.asarray(a, np.float32)
    b = b.numpy().astype(np.float32)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize(
    "case", ["full_u32", "small_spp", "seed_hi_bit_clear"]
)
def test_cmj_draws_bit_equal(case):
    """cmj_1d/cmj_2d on random (spp, pixel, depth, seed) tuples: bit-equal
    values and equal states after every draw (tolerance: none)."""
    rng = np.random.default_rng(["full_u32", "small_spp", "seed_hi_bit_clear"].index(case))
    n = 4096
    hi = 64 if case == "small_spp" else 2**32
    spp, pix, depth = _u32(rng, n, hi), _u32(rng, n), _u32(rng, n, 2**32 if case == "full_u32" else 40)
    seed = int(rng.integers(0, 2**31)) if case != "full_u32" else 0xFFFFFFFF
    js, ts = _states(spp, pix, depth, seed)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())
    for k in range(6):
        if k % 2:
            a, js = jcmj.cmj_1d(js)
            b, ts = tcmj.cmj_1d(ts)
        else:
            a, js = jcmj.cmj_2d(js)
            b, ts = tcmj.cmj_2d(ts)
        _assert_bits(a, b)
        np.testing.assert_array_equal(np.asarray(js.depth).astype(np.int64), ts.depth.numpy())


def test_xxhash32_bit_equal():
    rng = np.random.default_rng(7)
    x, y, z, w = (_u32(rng, 10000) for _ in range(4))
    a = jcmj.xxhash32(*(jnp.asarray(v) for v in (x, y, z, w)))
    b = tcmj.xxhash32(*(torch.from_numpy(v.astype(np.int64)) for v in (x, y, z, w)))
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())


@pytest.mark.parametrize("w,h", [(64, 36), (1280, 720)])
def test_camera_rays_match(w, h):
    """Primary rays agree to 1e-6 (absolute, unit directions)."""
    pos, d, fov = (0.0, 6.0, -16.5), (0.0, -0.28, 1.0), np.radians(40.0)
    jc = jcam.make_camera(pos, d, fov)
    tc = tcam.make_camera(pos, d, fov, "cpu")
    for a, b, c in zip(jc, tc, interop.camera_from_numpy(jc, "cpu")):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(np.asarray(a), c.numpy())
    rng = np.random.default_rng(3)
    pix = rng.integers(0, w * h, 4096).astype(np.uint32)
    spp = rng.integers(0, 512, 4096).astype(np.uint32)
    js, ts = _states(spp, pix, np.zeros_like(pix), 5)
    jo, jd, js = jcam.camera_rays(jc, w, h, jnp.asarray(pix), js)
    to, td, ts = tcam.camera_rays(tc, w, h, torch.from_numpy(pix.astype(np.int64)), ts)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(np.asarray(js.depth).astype(np.int64), ts.depth.numpy())


def test_chain_of_five_draws_bit_equal_to_jax():
    """cmj_2d, cmj_1d, cmj_4d, cmj_3d, cmj_2d threaded through one state,
    depth starting at 0xFFFFFFFF - 2 so the counter wraps on the way."""
    rng = np.random.default_rng(17)
    n = 4096
    spp, pix = _u32(rng, n), _u32(rng, n)
    js, ts = _states(spp, pix, np.full(n, 0xFFFFFFFD, np.uint32), 0xFFFFFFFF)
    for name in ("cmj_2d", "cmj_1d", "cmj_4d", "cmj_3d", "cmj_2d"):
        a, js = getattr(jcmj, name)(js)
        b, ts = getattr(tcmj, name)(ts)
        _assert_bits(a, b)
        np.testing.assert_array_equal(np.asarray(js.depth).astype(np.int64), ts.depth.numpy())


def _kernel_must_not_run():
    raise AssertionError("the CUDA kernel was bound")


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_cpu_state_takes_the_plain_path(width, monkeypatch):
    """A CPU state never reaches the kernel: `LAUNCHES` stays, the values
    are the torch code's, and the state given is left as it was."""
    monkeypatch.setattr(tcmj, "_kernel_fn", _kernel_must_not_run)
    rng = np.random.default_rng(width)
    spp, pix, depth = _u32(rng, 1000), _u32(rng, 1000), _u32(rng, 1000)
    _, st = _states(spp, pix, depth, 12345)
    before = [x.clone() for x in st[:4]]
    launches = tcmj.LAUNCHES
    got, new = getattr(tcmj, f"cmj_{width}d")(st)
    want, want_st = tcmj.draw_plain(st, width)
    assert tcmj.LAUNCHES == launches
    assert got.shape == ((1000, width) if width > 1 else (1000,))
    assert torch.equal(got, want) and torch.equal(new.depth, want_st.depth)
    assert torch.equal(new.depth, (st.depth + (1 if width <= 2 else 2)) & tcmj.M32)
    for a, b in zip(st[:4], before):
        assert torch.equal(a, b)


def test_draw_counters_record_under_a_profiler():
    """`sampling.draws` counts every draw (not `make_cmj_state`), and a CPU
    draw adds nothing to `sampling.draws_kernel`; off the profiler, nothing."""
    st = tcmj.make_cmj_state(torch.arange(64), torch.arange(64), 3)
    timer.take()
    tcmj.cmj_2d(st)
    assert timer.take() == ([], {})
    with profile(activities=[ProfilerActivity.CPU]):
        st = tcmj.make_cmj_state(torch.arange(64), torch.arange(64), 3)
        for draw in (tcmj.cmj_1d, tcmj.cmj_2d, tcmj.cmj_3d, tcmj.cmj_4d):
            _, st = draw(st)
    spans, counts = timer.take()
    assert counts == {"sampling.draws": 4}
    assert [s[0] for s in spans] == ["sampling.draw"] * 5


@pytest.mark.parametrize("fault", ["dtype", "shape", "device"])
def test_cuda_wrapper_rejects_fields_it_cannot_take(fault, monkeypatch):
    """The kernel's wrapper checks the four fields before it binds or
    launches anything: int64, one shape, one device."""
    monkeypatch.setattr(tcmj, "_kernel_fn", _kernel_must_not_run)
    st = tcmj.make_cmj_state(torch.arange(8), torch.arange(8), 1)
    bad = {"dtype": st.depth.to(torch.int32), "shape": st.depth[:4],
           "device": torch.empty(8, dtype=torch.int64, device="meta")}[fault]
    launches = tcmj.LAUNCHES
    with pytest.raises(ValueError, match="state.depth"):
        tcmj._draw_cuda(st._replace(depth=bad), 2)
    assert tcmj.LAUNCHES == launches
