"""Milliseconds of device time that NCCL's kernels (`nccl` in the kernel's
name) took on rank 0 in the traced frame: the all-reduce of each pixel
group's film and trace count, and the program's broadcasts of rank 0's
decisions. An NCCL kernel runs from its launch until every rank has joined
it, so this time holds the exchange itself and rank 0's wait for the
slowest peer: the exchange and the imbalance between shards together.
None where the trace holds no NCCL kernel (one chip, or a gloo group)."""

KERNELS = r"nccl"


def read(ctx):
    t = ctx.get("trace")
    if t is None:
        return None
    s = t.seconds_of(KERNELS)
    return 1e3 * s if s > 0 else None
