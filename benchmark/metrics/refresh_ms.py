"""Mean milliseconds of one refresh of the accel pack in the traced frame:
the program's `accel.refresh` spans (an animated scene's cluster pack
rebuilt from its planned order on the device, `build_binned_from_order`),
host time. The span is not fenced, so on the card this is the time the host
takes to issue the refresh's torch ops (`launches_per_refresh` counts
them), not the device's work, which runs behind it on the stream. None where
the frame has none (a static scene, or a program without the span)."""

from hbench.spans import named


def read(ctx):
    r = named(ctx, "accel.refresh")
    if not r:
        return None
    return sum(e - s for s, e in r) / len(r) * 1e-6
