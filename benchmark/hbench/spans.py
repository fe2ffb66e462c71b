"""The program's spans and counters of the traced frame, as the program
records them while the profiler is on (`henjou_torch/utils/timer.py`):
`ctx["traced"][0]["spans"]`, each [name, index of the enclosing span or
-1, start ns, end ns] on the Unix-ns clock of the device trace, and
`ctx["traced"][0]["counters"]`. A program that records none (one older
than its spans) gives None here, and its readers report nothing."""

from __future__ import annotations

# the host's kernel-launch calls in the device trace
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel")


def traced(ctx, key: str = "spans"):
    """The traced frame's spans (or, with key "counters", its counters),
    None where it has none."""
    frames = ctx.get("traced") or []
    return frames[0].get(key) if frames else None


def named(ctx, name: str) -> list:
    """[(start_ns, end_ns)] of the traced frame's spans called `name`."""
    return [(s, e) for n, _, s, e in traced(ctx) or [] if n == name]


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def share_of_window_pct(ctx, name: str):
    """The union of the `name` spans over the traced window, in %."""
    t = ctx.get("trace")
    spans = named(ctx, name)
    if t is None or t.window_s <= 0 or not spans:
        return None
    return 100.0 * sum(e - s for s, e in merged(spans)) * 1e-9 / t.window_s


def innermost(spans) -> list:
    """[(start, end, name)] over the union of `spans`, each piece named by
    the innermost span open over it (spans nest as they were opened)."""
    out, stack, cur = [], [], None
    for name, _, start, end in sorted(spans, key=lambda s: (s[2], -s[3])):
        while stack and stack[-1][1] <= start:
            top, top_end = stack.pop()
            if top_end > cur:
                out.append((cur, top_end, top))
                cur = top_end
        if stack and start > cur:
            out.append((cur, start, stack[-1][0]))
        cur = start
        stack.append((name, end))
    while stack:
        top, top_end = stack.pop()
        if top_end > cur:
            out.append((cur, top_end, top))
            cur = top_end
    return out


def idle_by_span(spans, busy) -> dict:
    """ns of the gaps between the union of the device's `busy` (start, end)
    intervals, by the innermost span open over each part of a gap (by
    overlap, not by where the gap begins); None where no span is."""
    gaps = [(a[1], b[0]) for a, b in zip(merged(busy), merged(busy)[1:])]
    pieces = innermost(spans)
    by = {None: 0}
    j = 0
    for g0, g1 in gaps:
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        left = g1 - g0
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            lap = min(g1, pieces[k][1]) - max(g0, pieces[k][0])
            by[pieces[k][2]] = by.get(pieces[k][2], 0) + lap
            left -= lap
            k += 1
        by[None] += left
    return by
