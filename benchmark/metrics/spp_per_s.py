"""Samples per pixel per second over the window: the spp of every frame
completed in it over the time from its opening to the end of its last
frame, finalize, checkpoints and PNGs included."""


def read(ctx):
    w = ctx["window"]
    if not w["frames"]:
        return None
    return sum(f["spp"] for f in w["frames"]) / (w["t_close"] - w["t_open"])
