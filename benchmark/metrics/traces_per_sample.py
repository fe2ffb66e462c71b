"""Traces cast per pixel-sample over the window's frames (exact counts):
n_traces over spp x width x height."""


def read(ctx):
    fr = ctx["window"]["frames"]
    n = sum(f["spp"] for f in fr) * ctx["width"] * ctx["height"]
    if n <= 0:
        return None
    return sum(f["n_traces"] for f in fr) / n
