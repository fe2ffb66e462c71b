"""The animated contest cell, rtcamp720turntable.contest: its two readers of
the accel refresh against hand-made spans and a hand-made device trace,
its option resolving to the turntable scene, and a planted fault in the
refresh path (the pack of frame 1 reused for every later frame) that a toy
run on the CPU must judge not correct."""

import os

import pytest

from hbench import spec
from hbench.trace import DeviceTrace

from test_hbench_runs import _run

CELL = "rtcamp720turntable.contest"
MS = 1_000_000  # ns

# a traced frame: its scene with one refresh, then the render with a bounce
SPANS = [
    ["frame.scene", -1, 0, 10 * MS],
    ["accel.refresh", 0, 1 * MS, 4 * MS],
    ["frame.render", -1, 12 * MS, 40 * MS],
    ["engine.bounce", 2, 14 * MS, 30 * MS],
]
KERNELS = [("elementwise", 2 * MS, 3 * MS), ("walk_kernel", 15 * MS, 16 * MS)]
RUNTIME = [("cudaLaunchKernel", 1 * MS + 10, 1 * MS + 20),
           ("cudaLaunchKernel", 2 * MS, 2 * MS + 10),
           ("cuLaunchKernel", 3 * MS, 3 * MS + 10),
           ("cudaMemcpyAsync", 3 * MS + 50, 3 * MS + 90),
           ("cudaLaunchKernel", 4 * MS, 4 * MS + 10),  # at the refresh's end: outside
           ("cudaLaunchKernel", 15 * MS, 15 * MS + 10)]


def _ctx(spans=SPANS, kernels=KERNELS):
    return {"trace": DeviceTrace(kernels, RUNTIME, 0.050),
            "traced": [{"frame": 9, "spp": 2, "spans": spans}]}


def _read(name, ctx):
    return spec.metric_reader(name).read(ctx)


def test_refresh_readers():
    assert _read("refresh_ms", _ctx()) == pytest.approx(3.0)
    # 1 ms + 10 ns, 2 ms and 3 ms start inside the refresh; 4 ms is its end
    assert _read("launches_per_refresh", _ctx()) == pytest.approx(3.0)
    two = SPANS + [["frame.finalize", -1, 41 * MS, 49 * MS],
                   ["accel.refresh", 4, 42 * MS, 43 * MS]]
    assert _read("refresh_ms", _ctx(two)) == pytest.approx(2.0)
    assert _read("launches_per_refresh", _ctx(two)) == pytest.approx(1.5)


@pytest.mark.parametrize("name", ["refresh_ms", "launches_per_refresh"])
def test_refresh_readers_without_spans_report_nothing(name):
    """A static scene's frame, or a program older than the span: None,
    nothing raised; without device kernels (the CPU) the launches reader
    gives None too."""
    no_refresh = [s for s in SPANS if s[0] != "accel.refresh"]
    assert _read(name, _ctx(no_refresh)) is None
    assert _read(name, {"trace": DeviceTrace(KERNELS, RUNTIME, 0.05),
                        "traced": [{"frame": 9, "spp": 2}]}) is None
    assert _read(name, {"traced": []}) is None
    if name == "launches_per_refresh":
        assert _read(name, _ctx(kernels=[])) is None


def test_option_resolves_to_the_turntable_scene():
    bench = spec.load_benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert entry["chips"] == 1
    cfg = spec.load_named("configs", entry["config"])
    opt = spec.run_option(cfg, spec.load_named("workloads", CELL), 2**31 + 3, "/x/run")
    assert opt["GLTF_file"]["gltf_filename"] == "rtcamp_turntable.gltf"
    assert os.path.exists(os.path.join(spec.ROOT, opt["GLTF_file"]["gltf_filepath"],
                                       "rtcamp_turntable.gltf"))
    # the contest option otherwise, as shipped but for the cut
    base = spec.load_named("configs", "rtcamp720")["option"]
    assert {k: v for k, v in cfg["option"].items() if k != "GLTF_file"} == \
        {k: v for k, v in base.items() if k != "GLTF_file"}


def test_traced_toy_run_reports_the_refresh():
    """A traced toy run on the CPU: the traced frame refreshes once and
    `refresh_ms` reads it; no device kernels, so no launches."""
    res, _ = _run(CELL, trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["refresh_ms"]["value"] > 0
    assert "launches_per_refresh" not in res["metrics"]


def test_stale_pack_is_not_correct(monkeypatch):
    """The refresh path broken underneath: the pack of the first refresh
    (frame 1) is handed back for every later frame, so frames 2 on trace
    last frame's geometry while shading this frame's."""
    from henjou_torch.accel import pallas_binned

    build = pallas_binned.build_binned_from_order
    first = []

    def stale(*a, **k):
        if not first:
            first.append(build(*a, **k))
        return first[0]

    monkeypatch.setattr(pallas_binned, "build_binned_from_order", stale)
    res, nums = _run(CELL)
    assert len(first) == 1
    assert not res["correct"], res["checks"]
