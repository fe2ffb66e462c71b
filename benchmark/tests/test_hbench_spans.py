"""The readers of the program's spans and counters against hand-made spans
and a hand-made device trace (the overlap rule of idle_unattributed_pct
included), and a traced CPU toy run of each cell reporting the span
metrics that need no device kernels, under the cell's split names."""

import pytest

from hbench import spec
from hbench.spans import idle_by_span, innermost, merged
from hbench.trace import DeviceTrace

from test_hbench_runs import _run

MS = 1_000_000  # ns

# a traced frame: two bounces, each with a trace (a sort inside) and
# draws; the film's read-back and a checkpoint after them
SPANS = [
    ["frame.render", -1, 0, 40 * MS],
    ["engine.step", 0, 1 * MS, 30 * MS],
    ["engine.bounce", 1, 2 * MS, 12 * MS],
    ["sampling.draw", 2, 2 * MS, 3 * MS],
    ["engine.trace", 2, 4 * MS, 10 * MS],
    ["accel.sort", 4, 4 * MS, 6 * MS],
    ["engine.bounce", 1, 14 * MS, 20 * MS],
    ["sampling.draw", 6, 14 * MS, 15 * MS],
    ["sampling.draw", 6, 14 * MS + MS // 2, 16 * MS],  # overlaps the one before
    ["engine.trace", 6, 16 * MS, 18 * MS],
    ["frame.film_readback", 0, 31 * MS, 33 * MS],
    ["frame.checkpoint", 0, 34 * MS, 39 * MS],
]
KERNELS = [("walk_kernel", 0, 1 * MS), ("add", 5 * MS, 7 * MS), ("mul", 9 * MS, 11 * MS),
           ("add", 15 * MS, 16 * MS), ("Memcpy DtoH", 32 * MS, 33 * MS),
           ("add", 44 * MS, 45 * MS)]
RUNTIME = [("cudaLaunchKernel", 0, 1), ("cudaLaunchKernel", 4 * MS, 4 * MS + 10),
           ("cudaLaunchCooperativeKernel", 5 * MS, 5 * MS + 10),
           ("cuLaunchKernel", 14 * MS, 14 * MS + 10), ("cudaMemcpyAsync", 16 * MS, 17 * MS),
           ("cudaLaunchKernel", 20 * MS, 20 * MS + 10),  # at a bounce's end: outside
           ("cudaLaunchKernel", 43 * MS, 43 * MS + 10)]


def _ctx(spans=SPANS, kernels=KERNELS, counters=None):
    frame = {"frame": 7, "spp": 2, "spans": spans}
    if counters is not None:
        frame["counters"] = counters
    return {"trace": DeviceTrace(kernels, RUNTIME, 0.050), "traced": [frame]}


def _read(name, ctx):
    return spec.metric_reader(name).read(ctx)


def test_merged_and_innermost():
    assert merged([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]
    pieces = innermost(SPANS[:6])
    assert pieces == [(0, MS, "frame.render"), (MS, 2 * MS, "engine.step"),
                      (2 * MS, 3 * MS, "sampling.draw"), (3 * MS, 4 * MS, "engine.bounce"),
                      (4 * MS, 6 * MS, "accel.sort"), (6 * MS, 10 * MS, "engine.trace"),
                      (10 * MS, 12 * MS, "engine.bounce"), (12 * MS, 30 * MS, "engine.step"),
                      (30 * MS, 40 * MS, "frame.render")]


def test_idle_goes_to_the_innermost_span_by_overlap():
    """The gap 1-5 ms begins under engine.step and runs through a draw, the
    bounce and the sort: each gets its part, not the span where it began.
    The gap 33-44 ms leaves the frame at 40 ms: 4 ms to nothing."""
    by = idle_by_span(SPANS, [(s, e) for _, s, e in KERNELS])
    # the device's gaps: 1-5, 7-9, 11-15, 16-32, 33-44 ms, 37 ms idle
    assert by == {"engine.step": 1 * MS + 2 * MS + 10 * MS, "sampling.draw": 2 * MS,
                  "engine.bounce": 4 * MS, "accel.sort": 1 * MS, "engine.trace": 4 * MS,
                  "frame.render": 3 * MS, "frame.film_readback": 1 * MS,
                  "frame.checkpoint": 5 * MS, None: 4 * MS}
    assert sum(by.values()) == 37 * MS
    assert _read("idle_unattributed_pct", _ctx()) == pytest.approx(100 * 4 / 37)


def test_span_readers():
    ctx = _ctx(counters={"engine.lane_slots": 400, "engine.lanes_valid": 300})
    assert _read("bounce_ms", ctx) == pytest.approx(8.0)  # (10 + 6) / 2
    # launches starting inside a bounce: 4 ms, 5 ms, 14 ms; 20 ms is its end
    assert _read("launches_per_bounce", ctx) == pytest.approx(1.5)
    # draws: [2, 3] and the union [14, 16] over a 50 ms window
    assert _read("sampling_pct", ctx) == pytest.approx(100 * 3 / 50)
    assert _read("ray_trace_pct", ctx) == pytest.approx(100 * 8 / 50)
    assert _read("film_readback_ms", ctx) == pytest.approx(2.0)
    assert _read("checkpoint_ms", ctx) == pytest.approx(5.0)
    assert _read("lane_occupancy_pct", ctx) == pytest.approx(75.0)


@pytest.mark.parametrize("name", ["bounce_ms", "launches_per_bounce", "sampling_pct",
                                  "ray_trace_pct", "film_readback_ms", "checkpoint_ms",
                                  "idle_unattributed_pct", "lane_occupancy_pct"])
def test_a_program_without_spans_reports_nothing(name):
    """The parent of the spans records none: every reader gives None and
    raises nothing; without device kernels (the CPU) neither do the two
    that read them."""
    frame = {"frame": 7, "spp": 2}
    assert _read(name, {"trace": DeviceTrace(KERNELS, RUNTIME, 0.05), "traced": [frame]}) is None
    assert _read(name, {"traced": []}) is None
    if name in ("launches_per_bounce", "idle_unattributed_pct"):
        assert _read(name, _ctx(kernels=[])) is None


def test_span_tables():
    """benchmark/span_tables.py's tables of a traced frame: host self time
    and device idle time by span, and nothing from a program without
    spans."""
    from span_tables import tables

    t = tables(_ctx())
    assert t["n_spans"] == len(SPANS) and t["spans_by_name"]["sampling.draw"] == 3
    assert t["idle_total_s"] == pytest.approx(0.037)
    assert t["idle_s_by_span"][0] == ["engine.step", pytest.approx(0.013)]
    assert ["(no span)", pytest.approx(0.004)] in t["idle_s_by_span"]
    # self: engine.step holds 1-2, 12-14 and 20-30 ms outside its children
    assert dict(t["self_s_by_span"])["engine.step"] == pytest.approx(0.013)
    assert tables({"traced": [{"frame": 7}]}) == {}
    assert "idle_s_by_span" not in tables(_ctx(kernels=[]))


KERNEL_FREE = ("bounce_ms", "sampling_pct", "ray_trace_pct", "film_readback_ms",
               "checkpoint_ms")
BENCH = spec.load_benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_traced_toy_run_reports_the_span_metrics(cell):
    res, _ = _run(cell, trace=True)
    assert res["correct"]
    masked = cell.endswith(".masked")
    want = {q + ".masked" if masked else q for q in KERNEL_FREE}
    if not masked:
        want.add("lane_occupancy_pct")
    assert want <= set(res["metrics"]), sorted(res["metrics"])
    # no device kernels on the CPU; the other cell's names are not reported
    assert not {"launches_per_bounce", "idle_unattributed_pct"} & {
        spec.quantity(m) for m in res["metrics"]}
    assert not {q + ("" if masked else ".masked") for q in KERNEL_FREE} & set(res["metrics"])
    for q in KERNEL_FREE:
        v = res["metrics"][q + ".masked" if masked else q]["value"]
        assert v > 0 and (not q.endswith("_pct") or v < 100)
