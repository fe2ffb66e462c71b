"""Percent of the device's idle time in the traced frame that no span of
the program accounts for: of the gaps between the union of the device's
operation intervals, the part over which no recorded span was open. Each
gap's time goes, by overlap, to the innermost span open over it
(hbench.spans.idle_by_span); this is what goes to none. None off the
card."""

from hbench.spans import idle_by_span, traced


def read(ctx):
    t = ctx.get("trace")
    spans = traced(ctx)
    if t is None or not t.kernels or not spans:
        return None
    by = idle_by_span(spans, [(s, e) for _, s, e in t.kernels])
    total = sum(by.values())
    return 100.0 * by[None] / total if total > 0 else None
