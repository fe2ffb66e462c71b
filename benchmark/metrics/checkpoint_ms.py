"""Milliseconds of the traced frame spent writing its checkpoint after each
spp batch (`np.savez` and the rename): the sum of the program's
`frame.checkpoint` spans."""

from hbench.spans import named


def read(ctx):
    s = named(ctx, "frame.checkpoint")
    return sum(e - b for b, e in s) * 1e-6 if s else None
