"""The reader of the wavefront engine's graph counters, `graph_replay_pct`,
against hand-made counters of a traced frame."""

import pytest

from hbench import spec
from hbench.trace import DeviceTrace


def _read(counters):
    frame = {"frame": 7, "spp": 2, "spans": []}
    if counters is not None:
        frame["counters"] = counters
    ctx = {"trace": DeviceTrace([], [], 0.05), "traced": [frame]}
    return spec.metric_reader("graph_replay_pct").read(ctx)


@pytest.mark.parametrize("counters, want", [
    ({"engine.graph_replays": 297, "engine.graph_captures": 3}, 99.0),
    ({"engine.graph_replays": 40}, 100.0),
    ({"engine.graph_captures": 6}, 0.0),
])
def test_graph_replay_pct(counters, want):
    """Replayed segments over replayed and captured ones."""
    assert _read(counters) == pytest.approx(want)


@pytest.mark.parametrize("counters", [None, {}, {"engine.lane_slots": 400}])
def test_graph_replay_pct_reports_nothing_without_the_counters(counters):
    """A program without the graphs (the parent, the CPU) counts neither:
    the reader gives None and raises nothing, with or without a traced
    frame."""
    assert _read(counters) is None
    assert spec.metric_reader("graph_replay_pct").read({"traced": []}) is None
