"""Percent of the wavefront engine's lane slots (lanes times loop
iterations) that held a valid path in the traced frame: the program's
`engine.lanes_valid` over `engine.lane_slots` counters, taken from the
loop's own read-back."""

from hbench.spans import traced


def read(ctx):
    c = traced(ctx, "counters") or {}
    if c.get("engine.lane_slots", 0) <= 0:
        return None
    return 100.0 * c["engine.lanes_valid"] / c["engine.lane_slots"]
