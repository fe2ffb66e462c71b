"""The device memory that the run held at its peak, in GiB: the CUDA
allocator's largest allocation total over set-up and the window, read once
the window has closed and before the reference runs. None off the card."""


def read(ctx):
    peak = ctx.get("memory_peak_bytes", 0)
    return peak / 2**30 if peak > 0 else None
