"""Milliseconds of the traced frame spent bringing each pixel group's film
to the host and adding it there: the sum of the program's
`frame.film_readback` spans (the wait for the device, the copy, the add)."""

from hbench.spans import named


def read(ctx):
    s = named(ctx, "frame.film_readback")
    return sum(e - b for b, e in s) * 1e-6 if s else None
