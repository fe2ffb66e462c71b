"""Kernel launches in the traced window (memory copies and sets left out)
over the samples per pixel completed in it."""


def read(ctx):
    t = ctx.get("trace")
    spp = sum(f["spp"] for f in ctx.get("traced", []))
    if t is None or spp <= 0 or not t.kernels:
        return None
    return t.launches() / spp
