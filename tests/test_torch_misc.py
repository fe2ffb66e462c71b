"""The port's test-only leftovers against the JAX package's
(tests/test_misc_parity.py:17, :36).

1. FastMultipleGGX (`bsdf/fastggx.py`): `fast_ggx_sample` and
   `fast_ggx_eval` against JAX's on the same directions, roughness and CMJ
   states made with numpy from a seed, with tests/test_torch_bsdf.py's
   limits: eval within rtol 1e-5, atol 1e-6; a sample's bsdf, wi and pdf
   there on all but 2e-3 of the values and within rtol 2e-2, atol 1e-4 on
   every one (XLA's and torch's sin, cos and sqrt differ in the last ulps,
   which a peaked lobe amplifies on a few lanes); and the compensation
   returning more energy than single-scatter GGX.
2. `Timer` and `phase_log` (`utils/timer.py`): the clock, the fence on CPU
   tensors and nested containers, the banner lines.
"""

import logging
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from henjou_torch.bsdf import fastggx as tfg
from henjou_torch.bsdf.ggx import ggx_sample as t_ggx_sample
from henjou_torch.sampling.cmj import make_cmj_state as t_state
from henjou_torch.utils.timer import Timer, fence, phase_log
from henjou_tpu.bsdf import fastggx as jfg
from henjou_tpu.sampling.cmj import make_cmj_state as j_state

from tests.test_torch_bsdf import ATOL, RTOL, _close_sample

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

N = 1 << 14


def _inputs(seed):
    rng = np.random.default_rng(seed)
    wo = rng.normal(size=(N, 3)).astype(np.float32)
    wo[:, 1] = np.abs(wo[:, 1]) + 0.05
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    f0 = rng.uniform(0.02, 1.0, (N, 3)).astype(np.float32)
    rough = rng.uniform(0.05, 1.0, N).astype(np.float32)
    spp = (np.arange(N) % 64).astype(np.uint32)
    pix = np.arange(N, dtype=np.uint32)
    return wo, f0, rough, spp, pix


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_ggx_sample_matches_jax(seed):
    wo, f0, rough, spp, pix = _inputs(seed)
    jb, jwi, jpdf, jst = jax.jit(jfg.fast_ggx_sample)(
        jnp.asarray(f0), jnp.asarray(rough), jnp.asarray(wo), j_state(spp, pix, 3))
    tb, twi, tpdf, tst = tfg.fast_ggx_sample(
        torch.from_numpy(f0), torch.from_numpy(rough), torch.from_numpy(wo),
        t_state(torch.from_numpy(spp.astype(np.int64)), torch.from_numpy(pix.astype(np.int64)), 3))
    _close_sample((jb, jwi, jpdf, jst), (tb, twi, tpdf, tst), f"seed {seed}")
    assert torch.isfinite(tb).all() and (tb >= 0).all()


def test_fast_ggx_eval_matches_jax():
    wo, f0, rough, _, _ = _inputs(2)
    wi = np.random.default_rng(3).normal(size=(N, 3)).astype(np.float32)
    wi[:, 1] = np.abs(wi[:, 1]) + 0.05
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    want = jax.jit(jfg.fast_ggx_eval)(jnp.asarray(f0), jnp.asarray(rough), jnp.asarray(wo),
                                      jnp.asarray(wi))
    got = tfg.fast_ggx_eval(*(torch.from_numpy(x) for x in (f0, rough, wo, wi)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_fast_ggx_adds_compensation():
    wo = torch.tensor([0.3, 0.8, 0.1]) / torch.linalg.norm(torch.tensor([0.3, 0.8, 0.1]))
    wo = wo.expand(N, 3).contiguous()
    st = t_state(torch.arange(N) % 64, torch.arange(N), 3)
    f0, rough = torch.ones(N, 3), torch.ones(N)

    def energy(fn):
        b, wi, pdf, _ = fn(f0, rough, wo, st)
        return float((b * torch.abs(wi[:, 1:2]) / pdf[:, None]).mean())

    assert energy(tfg.fast_ggx_sample) > energy(t_ggx_sample)


def test_timer_and_phase_log(caplog):
    t = Timer().start()
    time.sleep(0.01)
    x = torch.ones(8) * 2
    dt = t.stop(fence_value={"a": [x, (x,)], "b": None})
    assert dt >= 0.01 and t.ms >= 10.0 and t.us == pytest.approx(t.seconds * 1e6)
    fence(x)  # CPU tensors need no fence
    with caplog.at_level(logging.INFO, logger="henjou_torch"):
        with phase_log("unit-test-phase", fence_value=x) as pt:
            time.sleep(0.002)
    assert pt.seconds >= 0.002
    text = caplog.text
    assert "---- unit-test-phase start ----" in text and "---- unit-test-phase end:" in text
