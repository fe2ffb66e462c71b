"""Kernel launches issued per bounce in the traced frame: the host's launch
calls in the device trace (cudaLaunchKernel, cudaLaunchCooperativeKernel,
cuLaunchKernel) that start inside one of the program's `engine.bounce`
spans, over the number of those spans. None off the card."""

from bisect import bisect_right

from hbench.spans import LAUNCHES, merged, named


def read(ctx):
    t = ctx.get("trace")
    b = named(ctx, "engine.bounce")
    if t is None or not t.kernels or not b:
        return None
    spans = merged(b)
    starts = [s for s, _ in spans]
    n = 0
    for name, s, _ in t.runtime:
        if name in LAUNCHES:
            i = bisect_right(starts, s) - 1
            n += i >= 0 and s < spans[i][1]
    return n / len(b)
