"""The program's spans and counters (`henjou_torch/utils/timer.py`) on the
CPU at toy sizes:

- without a profiler session nothing is recorded, and a frame's AOVs are
  bit-equal to the same frame rendered under torch.profiler;
- under the profiler, both engines' frames carry spans of the documented
  names, nested as opened, every trace inside a bounce; the wavefront
  engine's lane counters, both engines' draw and BSDF call counters (on
  the CPU none through a kernel), and the static
  scene's one host pack (frame 0), inside the frame's scene;
- a span's stamps share the clock of the profiler's events;
- the functions the benchmark's hooks wrap stay module-level functions
  without a closure;
- `render.py --profile`'s idle seconds by innermost span;
- on the card (`-m cuda`): a span around one `bitonic_sort` holds its
  kernels' launch calls under a profiler with CUDA activity alone.
"""

import dataclasses
import functools
import os
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from henjou_torch import render
from henjou_torch.accel import bitonic, pallas_binned
from henjou_torch.runtime.options import RenderMode, load_render_option
from henjou_torch.runtime.renderer import Renderer
from henjou_torch.utils import timer
from henjou_torch.utils.timer import span

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GALLERY = os.path.join(ROOT, "scenes", "sphere_gallery_option.json")
AOVS = ("color", "albedo", "normal", "variance", "count")


@functools.lru_cache(maxsize=None)
def _render(engine: str, profiled: bool, out_dir: str):
    """(frame_stats, [AOVs per frame]) of two DenoiseTemporal frames of the
    sphere gallery (3,844 triangles: the sorted binned trace) at 24x16,
    1 spp, on `engine`, under a CPU profiler or not."""
    opt = dataclasses.replace(
        load_render_option(GALLERY), image_width=24, image_height=16, max_spp=1,
        spp_batch=1, end_frame=2, render_mode=RenderMode.DENOISE_TEMPORAL, engine=engine,
        image_directory=out_dir, image_name=f"{engine}_{int(profiled)}")
    r = Renderer(option=opt, device="cpu")
    r._load_scene_from_option()
    films = []
    real = r.render_frame

    def kept(*a, **k):
        aovs = real(*a, **k)
        films.append({key: np.array(aovs[key]) for key in AOVS if key in aovs})
        return aovs

    r.render_frame = kept
    timer.take()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            r.initialize_and_render()
    else:
        r.initialize_and_render()
    return r.frame_stats, films


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("spans"))


@pytest.mark.parametrize("engine", ["wavefront", "masked"])
def test_untraced_render_records_nothing_and_matches_traced(engine, out_dir):
    stats, films = _render(engine, False, out_dir)
    assert len(stats) == 2 and all("spans" not in s and "counters" not in s for s in stats)
    assert timer.take() == ([], {})
    _, traced = _render(engine, True, out_dir)
    assert len(films) == len(traced) == 2
    for plain, prof in zip(films, traced):
        assert plain.keys() == prof.keys()
        for key in plain:
            np.testing.assert_array_equal(plain[key], prof[key], err_msg=key)


def _children_within_parents(spans):
    for name, parent, start, end in spans:
        assert name in timer.NAMES, name
        assert start <= end, name
        if parent >= 0:
            _, _, p_start, p_end = spans[parent]
            assert p_start <= start and end <= p_end, name


def _ancestors(spans, i):
    out = []
    while spans[i][1] >= 0:
        i = spans[i][1]
        out.append(spans[i][0])
    return out


@pytest.mark.parametrize("engine", ["wavefront", "masked"])
def test_traced_frames_carry_nested_spans(engine, out_dir):
    stats, _ = _render(engine, True, out_dir)
    for s in stats:
        spans = s["spans"]
        _children_within_parents(spans)
        names = {sp[0] for sp in spans}
        assert {"frame.scene", "frame.render", "engine.step", "engine.bounce", "engine.trace",
                "engine.shade", "engine.film", "engine.spawn", "sampling.draw",
                "accel.sort", "accel.intersect", "accel.unsort", "frame.film_readback",
                "frame.checkpoint", "frame.finalize", "finalize.upload", "finalize.probe",
                "finalize.denoise", "finalize.readback", "frame.output"} <= names
        for i, sp in enumerate(spans):
            up = _ancestors(spans, i)
            if sp[0] == "engine.trace" and "engine.step" in up:
                assert "engine.bounce" in up
            if sp[0] in ("accel.intersect", "accel.unsort"):
                assert up[0] == "engine.trace"
            if sp[0].startswith("finalize."):
                assert up[0] == "frame.finalize"
            if sp[0] == "accel.pack":
                assert up[0] == "frame.scene"
        n_bounce = sum(1 for sp in spans if sp[0] == "engine.bounce")
        c = s["counters"]
        # every draw and BSDF call is counted; on the CPU none goes through
        # a kernel
        assert c["sampling.draws"] > 0 and "sampling.draws_kernel" not in c
        assert "bsdf.calls_kernel" not in c
        # a static scene: frame 0 packs on the host, frame 1 reuses its pack
        first = s["frame"] == 0
        assert [sp[0] for sp in spans].count("accel.pack") == first
        assert not {"accel.plan", "accel.refresh"} & names
        if engine == "wavefront":
            assert 0 < c["engine.lanes_valid"] <= c["engine.lane_slots"]
            # one bounce per iteration of the lanes' loop
            assert c["engine.lane_slots"] == n_bounce * 4096
            assert "engine.readback" in names
            # one-sample MIS: eval and pdf for NEE, the continuation's sample
            assert c["bsdf.calls"] == 3 * n_bounce
        else:
            assert set(c) == {"sampling.draws", "bsdf.calls"} and "engine.readback" not in names
            assert n_bounce == 10  # one tile, one spp, the depth loop's 10 bounces
            # two-sample MIS: eval and pdf for NEE, the BSDF branch's sample
            # and the continuation's
            assert c["bsdf.calls"] == 4 * n_bounce


def test_span_shares_the_profilers_clock():
    """A span around a torch op contains that op's event as the profiler
    stamps it (Unix ns)."""
    x = torch.randn(256, 256)
    timer.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("engine.shade"):
            y = x @ x
    (name, parent, start, end), = timer.take()[0]
    assert (name, parent) == ("engine.shade", -1) and y.shape == (256, 256)
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert start <= mm[0].start_ns() and mm[0].start_ns() + mm[0].duration_ns() <= end


def test_count_and_span_record_only_under_a_profiler():
    timer.take()
    with span("engine.bounce") as s:
        timer.count("engine.lane_slots", 5)
    assert timer.take() == ([], {}) and not isinstance(s, span)
    with profile(activities=[ProfilerActivity.CPU]):
        with span("engine.bounce"):
            with span("engine.trace"):
                timer.count("engine.lane_slots", 5)
            timer.count("engine.lane_slots", 2)
    spans, counts = timer.take()
    assert [s[:2] for s in spans] == [["engine.bounce", -1], ["engine.trace", 0]]
    assert counts == {"engine.lane_slots": 7}


@pytest.mark.parametrize("fn", [pallas_binned.intersect_binned, bitonic.bitonic_sort,
                                bitonic.bitonic_unsort], ids=lambda f: f.__name__)
def test_hooked_functions_stay_plain_module_functions(fn):
    """The benchmark wraps these by swapping their code: they must stay
    module-level Python functions without a closure (no span decorator)."""
    assert isinstance(fn, types.FunctionType) and fn.__closure__ is None
    mod = __import__(fn.__module__, fromlist=["_"])
    assert getattr(mod, fn.__name__) is fn and fn.__qualname__ == fn.__name__


def test_profile_idle_by_innermost_span():
    """Each part of a device gap goes to the innermost span open over it,
    by overlap; no span, "(no span)"."""
    spans = [["frame.render", -1, 0, 100], ["engine.bounce", 0, 10, 60],
             ["engine.trace", 1, 20, 30], ["frame.output", -1, 150, 170]]
    assert render._innermost(spans) == [(0, 10, "frame.render"), (10, 20, "engine.bounce"),
                                        (20, 30, "engine.trace"), (30, 60, "engine.bounce"),
                                        (60, 100, "frame.render"),
                                        (150, 170, "frame.output")]
    # busy [0, 15], [25, 40], [95, 160]: gaps 15-25 and 40-95
    idle = render._idle_by_span(spans, [(0, 15), (25, 40), (95, 160), (1, 5)])
    want = {"frame.render": 35e-9, "engine.bounce": 25e-9, "engine.trace": 5e-9}
    assert idle.keys() == want.keys() | {"(no span)"} and idle["(no span)"] == 0
    for k, v in want.items():
        assert idle[k] == pytest.approx(v)
    assert render._idle_by_span(spans, [(0, 5), (120, 130)]) == pytest.approx(
        {"frame.render": 45e-9, "engine.bounce": 40e-9, "engine.trace": 10e-9,
         "(no span)": 20e-9})


@pytest.mark.cuda
def test_span_holds_the_sorts_launches_on_the_card():
    """Under a profiler with CUDA activity alone the spans record, and a
    span around one bitonic_sort holds the launch call of each of its
    kernels (matched by correlation id), on the clock of the trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    n = 1 << 16
    key = torch.randint(0, 1 << 24, (n,), dtype=torch.int32, device=dev)
    planes = [torch.randn(n, 3, device=dev), torch.arange(n, dtype=torch.int32, device=dev)]
    bitonic.bitonic_sort(key, *planes)  # build and warm up
    torch.cuda.synchronize(dev)
    timer.take()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x = key + 1  # a launch outside the span
        with span("accel.sort"):
            enabled = torch.autograd.profiler._is_profiler_enabled
            bitonic.bitonic_sort(key, *planes)
        torch.cuda.synchronize(dev)
    del x
    spans, _ = timer.take()
    assert enabled and len(spans) == 1
    _, _, start, end = spans[0]
    events = list(prof.profiler.kineto_results.events())
    kernels = [e for e in events if str(e.device_type()).endswith("CUDA")
               and "network<" in e.name()]
    launches = {e.correlation_id(): e for e in events
                if not str(e.device_type()).endswith("CUDA")
                and e.name() in ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                                 "cuLaunchKernel")}
    assert kernels and launches
    for k in kernels:
        call = launches.get(k.correlation_id()) or launches.get(k.linked_correlation_id())
        assert call is not None, k.name()
        assert start <= call.start_ns() and call.start_ns() + call.duration_ns() <= end
    outside = [e for e in launches.values() if not start <= e.start_ns() <= end]
    assert outside  # the add's launch lies outside
