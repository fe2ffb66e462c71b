"""Kernel launches issued per refresh of the accel pack in the traced
frame: the host's launch calls in the device trace (cudaLaunchKernel,
cudaLaunchCooperativeKernel, cuLaunchKernel) that start inside one of the
program's `accel.refresh` spans, over the number of those spans (read as
launches_per_bounce reads its bounces). None off the card or without the
span."""

from bisect import bisect_right

from hbench.spans import LAUNCHES, merged, named


def read(ctx):
    t = ctx.get("trace")
    r = named(ctx, "accel.refresh")
    if t is None or not t.kernels or not r:
        return None
    spans = merged(r)
    starts = [s for s, _ in spans]
    n = 0
    for name, s, _ in t.runtime:
        if name in LAUNCHES:
            i = bisect_right(starts, s) - 1
            n += i >= 0 and s < spans[i][1]
    return n / len(r)
