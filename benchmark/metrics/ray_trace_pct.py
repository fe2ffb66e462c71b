"""Percent of the traced window in which the host was inside a trace (a
closest hit with its payload fill, a shadow query, a light query): the
union of the program's `engine.trace` spans over the window's host
seconds."""

from hbench.spans import share_of_window_pct


def read(ctx):
    return share_of_window_pct(ctx, "engine.trace")
