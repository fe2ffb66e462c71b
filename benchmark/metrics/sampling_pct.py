"""Percent of the traced window in which the host was inside a CMJ or
Sobol draw: the union of the program's `sampling.draw` spans over the
window's host seconds."""

from hbench.spans import share_of_window_pct


def read(ctx):
    return share_of_window_pct(ctx, "sampling.draw")
