"""Percent of the wavefront engine's iteration segments that ran as a CUDA
graph replay in the traced frame: the program's `engine.graph_replays`
over `engine.graph_replays` plus `engine.graph_captures` counters (each
counts segments). None where the program counts neither (the CPU, or a
program without the graphs)."""

from hbench.spans import traced


def read(ctx):
    c = traced(ctx, "counters") or {}
    replays, captures = c.get("engine.graph_replays", 0), c.get("engine.graph_captures", 0)
    if replays + captures <= 0:
        return None
    return 100.0 * replays / (replays + captures)
