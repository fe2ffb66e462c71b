"""Mean milliseconds of one bounce in the traced frame: the program's
`engine.bounce` spans (one iteration of the wavefront loop, or one depth
of the masked depth loop over a tile), host time."""

from hbench.spans import named


def read(ctx):
    b = named(ctx, "engine.bounce")
    if not b:
        return None
    return sum(e - s for s, e in b) / len(b) * 1e-6
