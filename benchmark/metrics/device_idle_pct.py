"""Percent of the traced window (one frame, render to PNG) in which no
operation ran on the device: one minus the union of the device's operation
intervals over the window's host seconds."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
