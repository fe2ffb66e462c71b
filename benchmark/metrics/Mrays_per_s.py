"""Millions of traces per render second over the window's frames: the
engine's exact n_traces over render_s."""


def read(ctx):
    fr = ctx["window"]["frames"]
    s = sum(f["render_s"] for f in fr)
    if not fr or s <= 0:
        return None
    return sum(f["n_traces"] for f in fr) / s / 1e6
