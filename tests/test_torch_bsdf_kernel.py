"""The BSDF dispatch's kernels (`henjou_torch/csrc/bsdf.cu`) and their
wrappers in `henjou_torch/bsdf/dispatch.py`.

On the CPU: CPU tensors take the plain code (the torch code, which
tests/test_torch_bsdf.py holds to the JAX package) and launch nothing; the
counters `bsdf.calls` and `bsdf.calls_kernel` under a profiler; the
wrapper's input checks, which make strided inputs contiguous and reject
another dtype, shape or device.

On the card (`-m cuda`): `bsdf_sample`, `bsdf_eval` and `bsdf_pdf` each
one launch, bit-equal to the plain code on the same device (values, NaN
lanes as NaN, and the advanced depth) on 131,072 random lanes for every
combination of the four lobe flags, with the LUT and without, on CMJ and
Sobol-tagged states; the degenerate lanes among them (wo.y 0 and +-1,
roughness 0 and 1, walks that leave straight up or start straight down,
walks that exceed the scattering order or NaN); and one wavefront render
of the gallery with the kernels against the plain dispatch. This file
imports no JAX, so on the card:

    python -m pytest tests/test_torch_bsdf_kernel.py -m cuda --noconftest -q
"""

import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from henjou_torch.bsdf import dispatch
from henjou_torch.sampling import cmj
from henjou_torch.texture.lut import default_lut
from henjou_torch.utils import timer

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GALLERY = os.path.join(ROOT, "scenes", "sphere_gallery_option.json")
FLAGS = [(spec, metal, sheen, cc) for spec in (False, True) for metal in (False, True)
         for sheen in (False, True) for cc in (False, True)]


def _inputs(n, seed, device, sobol=False):
    """(hit, wo, wi, state) of `n` random lanes from numpy; the first lanes
    are the degenerate ones."""
    rng = np.random.default_rng(seed)
    f = dict(
        basecolor=rng.uniform(0, 1, (n, 3)),
        roughness=rng.uniform(0, 1, n),
        metallic=np.where(rng.uniform(size=n) < 0.4, 1.0, rng.uniform(0, 0.5, n)),
        sheen=rng.uniform(0, 1, n),
        clearcoat=rng.uniform(0, 1, n),
        ior=rng.uniform(1.2, 2.0, n),
        is_thinfilm=rng.uniform(size=n) < 0.3,
        is_specular=rng.uniform(size=n) < 0.2,
    )
    wo, wi = (rng.normal(size=(n, 3)) for _ in range(2))
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    if n >= 512:
        # every lobe on each degenerate lane: glass, metal, Disney in turn
        k = np.arange(512)
        f["is_specular"][:512] = k % 3 == 0
        f["metallic"][:512] = np.where(k % 3 == 1, 1.0, 0.5)  # 0.5 is not metal
        f["roughness"][0:64] = 0.0
        f["roughness"][64:128] = 1.0
        wo[128:160] = (0, 1, 0)    # the walk starts straight down
        wo[160:192] = (0, -1, 0)   # the walk leaves straight up at once
        wo[192:224] = (0.6, 0.0, 0.8)  # wo.y 0: horizontal
        wo[224:256] = (1.0, 0.0, 0.0)
        wi[256:288] = -wo[256:288]  # wo + wi = 0
        wi[288:320] = wo[288:320]
        f["roughness"][320:352] = np.nan  # NaN alpha: the walk NaNs
        wo[352:384] = np.nan
        f["basecolor"][384:416] = np.nan
        wo[416:448, 1] = 1e-5  # near horizontal
        f["roughness"][416:448] = 1.0
    f = {k: torch.from_numpy(v.astype(np.float32) if v.dtype.kind == "f" else v).to(device)
         for k, v in f.items()}
    wo, wi = (torch.from_numpy(v.astype(np.float32)).to(device) for v in (wo, wi))
    fields = [rng.integers(0, 4096, n), rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.int64),
              rng.integers(0, 40, n), rng.integers(0, 1 << 20, n)]
    edge = [0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFA, 0, 0xFFFFFFFF, 5, 0xFFFFFFF0, 0xFFFFFFFF]
    fields[2][:8] = edge[:min(n, 8)]  # dimension counters that wrap
    if sobol:
        fields[1] = np.where(np.arange(n) % 2 == 0, fields[1] | cmj.SOBOL_SEED_FLAG,
                             fields[1] & ~cmj.SOBOL_SEED_FLAG)
    state = cmj.CMJState(*(torch.from_numpy(x).to(device) for x in fields), sobol=sobol)
    return types.SimpleNamespace(**f), wo, wi, state


def _same(a, b):
    """Equal shape, dtype and values; NaN where the other is NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("flags", FLAGS[::5], ids=str)
def test_cpu_tensors_take_the_plain_code(flags):
    spec, metal, sheen, cc = flags
    hit, wo, wi, st = _inputs(2048, 1, "cpu")
    lut = default_lut("cpu")
    launches = dispatch.LAUNCHES
    got = dispatch.bsdf_sample(hit, wo, st, lut, spec, metal, sheen, cc)
    want = dispatch.sample_plain(hit, wo, st, lut, spec, metal, sheen, cc)
    for g, w in zip(got[:3], want[:3]):
        assert _same(g, w)
    assert torch.equal(got[3].depth, want[3].depth)
    assert _same(dispatch.bsdf_eval(hit, wo, wi, lut, sheen, cc),
                 dispatch.eval_plain(hit, wo, wi, lut, sheen, cc))
    assert _same(dispatch.bsdf_pdf(hit, wo, wi), dispatch.pdf_plain(hit, wo, wi))
    assert dispatch.LAUNCHES == launches


def test_counters_count_every_call_and_no_kernel_on_the_cpu():
    hit, wo, wi, st = _inputs(64, 2, "cpu")
    timer.take()
    with profile(activities=[ProfilerActivity.CPU]):
        _, _, _, st = dispatch.bsdf_sample(hit, wo, st)
        dispatch.bsdf_sample(hit, wo, st)
        dispatch.bsdf_eval(hit, wo, wi)
        dispatch.bsdf_pdf(hit, wo, wi)
    _, counts = timer.take()
    assert counts["bsdf.calls"] == 4 and "bsdf.calls_kernel" not in counts


def test_kernel_inputs_makes_strided_inputs_contiguous():
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    strided, vec, mask = base[:, 0], base[:, :3], torch.arange(8)[::2] % 3 == 0
    assert not strided.is_contiguous() and not vec.is_contiguous()
    got = dispatch.kernel_inputs(torch.Size([4]), torch.device("cpu"), [
        ("a", strided, torch.float32, ()), ("b", vec, torch.float32, (3,)),
        ("c", mask, torch.bool, ())])
    assert all(x.is_contiguous() for x in got)
    for g, w in zip(got, (strided, vec, mask)):
        assert torch.equal(g, w)
    ok = torch.zeros(4)
    assert dispatch.kernel_inputs(torch.Size([4]), torch.device("cpu"),
                                  [("a", ok, torch.float32, ())])[0] is ok


@pytest.mark.parametrize("bad", ["dtype", "shape", "trailing", "device"])
def test_kernel_inputs_rejects_what_the_kernels_cannot_read(bad):
    x = {"dtype": torch.zeros(4, 3, dtype=torch.float64), "shape": torch.zeros(5, 3),
         "trailing": torch.zeros(4, 4), "device": torch.zeros(4, 3, device="meta")}[bad]
    with pytest.raises(ValueError, match="local_wo"):
        dispatch.kernel_inputs(torch.Size([4]), torch.device("cpu"),
                               [("local_wo", x, torch.float32, (3,))])


@pytest.mark.parametrize("lut", [torch.zeros(8, 8, 4), torch.zeros(8, 8, 3, dtype=torch.float64),
                                 torch.zeros(64, 3)], ids=["channels", "dtype", "rank"])
def test_lut_that_the_kernels_cannot_read_is_rejected(lut):
    with pytest.raises(ValueError, match="lut"):
        dispatch._lut_args(lut, torch.device("cpu"))


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _walk_exits(hit, wo, out):
    """Lanes of the walk (metal, not glass) that ended exceeded or NaN:
    wi (0, 0, 1), bsdf 0 and pdf 1; those among finite inputs."""
    bsdf, wi, pdf, _ = out
    up = torch.tensor([0.0, 0.0, 1.0], device=wi.device)
    walk = (hit.metallic > 0.5) & ~hit.is_specular
    ended = walk & (wi == up).all(-1) & (pdf == 1.0) & (bsdf == 0.0).all(-1)
    finite = torch.isfinite(wo).all(-1) & torch.isfinite(hit.roughness)
    return int(ended.sum()), int((ended & finite).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("sobol", [False, True], ids=["cmj", "sobol"])
@pytest.mark.parametrize("with_lut", [False, True], ids=["no_lut", "lut"])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "".join("sMhc"[i] if v else "-"
                                                                for i, v in enumerate(f)))
def test_bsdf_kernels_match_plain(cuda, flags, with_lut, sobol):
    """One launch per call, bit-equal to the torch code on the same CUDA
    inputs; the inputs and the state's other fields untouched."""
    spec, metal, sheen, cc = flags
    hit, wo, wi, st = _inputs(131072, 17 + 2 * sobol + with_lut, cuda, sobol)
    lut = default_lut(cuda) if with_lut else None
    before = [x.clone() for x in (*vars(hit).values(), wo, wi, *st[:4])]
    launches = dispatch.LAUNCHES
    got = dispatch.bsdf_sample(hit, wo, st, lut, spec, metal, sheen, cc)
    got_eval = dispatch.bsdf_eval(hit, wo, wi, lut, sheen, cc)
    got_pdf = dispatch.bsdf_pdf(hit, wo, wi)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES == launches + 3
    want = dispatch.sample_plain(hit, wo, st, lut, spec, metal, sheen, cc)
    for name, g, w in zip(("bsdf", "wi", "pdf"), got[:3], want[:3]):
        assert _same(g, w), name
    assert torch.equal(got[3].depth, want[3].depth) and got[3].sobol == sobol
    for name in ("n_spp", "scramble", "image_idx"):
        assert getattr(got[3], name) is getattr(st, name)
    assert _same(got_eval, dispatch.eval_plain(hit, wo, wi, lut, sheen, cc))
    assert _same(got_pdf, dispatch.pdf_plain(hit, wo, wi))
    for a, b in zip((*vars(hit).values(), wo, wi, *st[:4]), before):
        assert _same(a, b)
    if metal:
        ended, ended_finite = _walk_exits(hit, wo, want)
        assert ended_finite > 0 and ended > ended_finite  # exceeded, and NaN exits


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(0,), (1,), (1000,), (256, 512)], ids=str)
def test_bsdf_kernels_any_lane_shape(cuda, shape):
    n = int(np.prod(shape))
    hit, wo, wi, st = _inputs(n, 5, cuda, sobol=True)
    view = {k: v.reshape(*shape, *v.shape[1:]) for k, v in vars(hit).items()}
    hit = types.SimpleNamespace(**view)
    wo, wi = wo.reshape(*shape, 3), wi.reshape(*shape, 3)
    st = st._replace(**{k: getattr(st, k).reshape(shape) for k in cmj.CMJState._fields[:4]})
    lut = default_lut(cuda)
    got = dispatch.bsdf_sample(hit, wo, st, lut)
    want = dispatch.sample_plain(hit, wo, st, lut)
    for g, w in zip(got[:3], want[:3]):
        assert _same(g, w)
    assert torch.equal(got[3].depth, want[3].depth)
    assert _same(dispatch.bsdf_eval(hit, wo, wi, lut), dispatch.eval_plain(hit, wo, wi, lut))
    assert _same(dispatch.bsdf_pdf(hit, wo, wi), dispatch.pdf_plain(hit, wo, wi))


@pytest.mark.cuda
def test_bsdf_kernels_on_strided_inputs(cuda):
    """Hit fields as column views of one block, wo as a strided view: the
    wrapper copies them, and the results equal the contiguous call's."""
    hit, wo, wi, st = _inputs(4096, 6, cuda)
    block = torch.stack([hit.roughness, hit.metallic, hit.sheen, hit.clearcoat, hit.ior], dim=1)
    strided = types.SimpleNamespace(**{**vars(hit), **{k: block[:, i] for i, k in enumerate(
        ("roughness", "metallic", "sheen", "clearcoat", "ior"))}})
    wo_s = torch.cat([wo, wo], dim=1)[:, :3]
    assert not wo_s.is_contiguous() and not strided.roughness.is_contiguous()
    got = dispatch.bsdf_sample(strided, wo_s, st)
    want = dispatch.bsdf_sample(hit, wo, st)
    for g, w in zip(got[:3], want[:3]):
        assert _same(g, w)
    assert torch.equal(got[3].depth, want[3].depth)


@pytest.mark.cuda
def test_gallery_render_kernels_against_plain_dispatch(cuda, monkeypatch):
    """The sphere gallery (meta-glass, metals, Disney with the thin-film LUT)
    through the wavefront engine, one-sample MIS at 64x36, 2 spp: with the
    kernels, then with the plain dispatch in their place; every pixel
    within the benchmark's 1e-4 + 1e-3 |ref|, counts equal."""
    from henjou_torch.accel.pallas_binned import make_binned_intersector
    from henjou_torch.accel.sorting import make_bitonic_sorted_intersector
    from henjou_torch.integrator.wavefront import wavefront_render
    from henjou_torch.runtime.renderer import Renderer

    def render():
        r = Renderer(device=cuda)
        r.load_render_option(GALLERY)
        r._load_scene_from_option()
        fs, accel, cam = r.frame_scene(0)
        ifn, ofn = make_bitonic_sorted_intersector(*make_binned_intersector(accel),
                                                   accel.scene_lo, accel.scene_hi)
        film = wavefront_render(fs, r.sky, cam, 64, 36, 2, r.bsdf_sample, bsdf_eval=r.bsdf_eval,
                                bsdf_pdf=r.bsdf_pdf, integrator="mis", seed=r._frame_seed(0),
                                lanes=4096, intersect_fn=ifn, occluded_fn=ofn, mis_single=True)
        torch.cuda.synchronize()
        return film

    launches = dispatch.LAUNCHES
    kernel = render()
    assert dispatch.LAUNCHES > launches
    for name, plain in (("bsdf_sample", dispatch.sample_plain),
                        ("bsdf_eval", dispatch.eval_plain), ("bsdf_pdf", dispatch.pdf_plain)):
        monkeypatch.setattr(dispatch, name, plain)
    launches = dispatch.LAUNCHES
    ref = render()
    assert dispatch.LAUNCHES == launches
    assert torch.equal(kernel.count, ref.count)
    a, b = (f.color / f.count.clamp(min=1)[:, None] for f in (kernel, ref))
    assert torch.isfinite(a).all()
    assert ((a - b).abs() <= 1e-4 + 1e-3 * b.abs()).all()
