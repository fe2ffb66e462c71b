"""The yardstick of the kernels' rooflines: the card's published bandwidth
and the bytes each call needs, counted from the call's shapes alone (each
input byte read once, each output byte written once), so the count is the
same whichever kernel implements the call."""

from __future__ import annotations

# NVIDIA H100 SXM (80 GB HBM3): the data sheet's memory bandwidth at 700 W
BYTES_PER_S = 3.35e12


def trace_bytes(rays: int, pack_bytes: int, any_hit: bool) -> int:
    """One closest-hit or any-hit trace of `rays` rays against a pack of
    `pack_bytes`: per ray the origin, direction, tmin and tmax read (32 B),
    the hit written (t, prim, u, v: 16 B; any-hit: a 4 B flag), and the
    pack read once."""
    return rays * (32 + (4 if any_hit else 16)) + pack_bytes


def sort_bytes(n: int, column_bytes: int, key_written: bool = True) -> int:
    """One keyed sort or unsort of `n` rows: the 4 B key (or lane id) read
    once, the sorted 4 B key written once where the call returns it (a
    sort, not an unsort), and `column_bytes` of payload per row read once
    and written once."""
    return n * (4 + (4 if key_written else 0) + 2 * column_bytes)


def checked_calls(sums, what: str):
    """A reader's hook sums once their device calls are the launches the
    program's own counter saw over the same window; None where no call
    launched. Raises where they differ: the bytes would then be counted
    over other calls than the kernels' device time."""
    if not sums:
        return None
    calls, launches = int(sums.get("calls", 0)), int(sums.get("launches", 0))
    if calls != launches:
        raise ValueError(f"{what}: {calls} calls counted on the device, "
                         f"{launches} launches counted by the program")
    return sums if calls else None


def share_pct(bytes_moved: float, device_s: float):
    """Percent of the bandwidth roofline: the least time the bytes need at
    the peak, over the measured device time; None without both."""
    if bytes_moved <= 0 or device_s <= 0:
        return None
    return 100.0 * (bytes_moved / BYTES_PER_S) / device_s
