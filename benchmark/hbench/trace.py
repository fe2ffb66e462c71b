"""The device trace of a traced window: `torch.profiler` with CUDA activity
only, read from the raw kineto events (no per-event Python objects are
built), reduced to kernel intervals, busy time as their union, idle gaps
labelled by the CUDA runtime call the host was in, and time by kernel name."""

from __future__ import annotations

import re
from collections import defaultdict

_HOST_IDLE = "host outside any CUDA call"


class DeviceTrace:
    """Kernels [(name, start_ns, end_ns)] and host runtime calls
    [(name, start_ns, end_ns)] of one traced window of `window_s` host
    seconds."""

    def __init__(self, kernels, runtime, window_s: float):
        self.kernels = sorted(kernels, key=lambda k: k[1])
        self.runtime = sorted(runtime, key=lambda r: r[1])
        self.window_s = float(window_s)

    @classmethod
    def from_profiler(cls, prof, window_s: float) -> "DeviceTrace":
        kernels, runtime = [], []
        for e in prof.profiler.kineto_results.events():
            dev = str(e.device_type())
            start = e.start_ns()
            end = start + e.duration_ns()
            if dev.endswith("CUDA"):
                kernels.append((e.name(), start, end))
            else:
                runtime.append((e.name(), start, end))
        # memcpy and memset activity count as device work, kernels by name
        return cls(kernels, runtime, window_s)

    def busy_s(self) -> float:
        """Seconds in which at least one operation ran on the device."""
        return union_seconds([(s, e) for _, s, e in self.kernels])

    def launches(self, pattern: str = r"^(?!Memcpy|Memset)") -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _ in self.kernels if rx.search(n))

    def seconds_of(self, pattern: str) -> float:
        """Summed device seconds of the operations whose name matches."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.kernels if rx.search(n)) * 1e-9

    def top_ops(self, n: int = 10):
        by = defaultdict(int)
        for name, s, e in self.kernels:
            by[short_name(name)] += e - s
        return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """Device idle time between operations, summed by what the host
        was doing when each gap began: the CUDA runtime call then running,
        else outside any CUDA call."""
        by = defaultdict(int)
        rt = self.runtime
        j = 0
        end = None
        for _, s, e in self.kernels:
            if end is not None and s > end:
                while j < len(rt) and rt[j][2] < end:
                    j += 1
                label = rt[j][0] if j < len(rt) and rt[j][1] <= end else _HOST_IDLE
                by[label] += s - end
            end = e if end is None else max(end, e)
        return [[k, v * 1e-9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its return type, namespaces of PyTorch and
    argument list, cut to `width` characters."""
    name = name.removeprefix("void ").split("(")[0].replace("at::native::", "")
    return name[:width]


def union_seconds(intervals) -> float:
    """Length of the union of (start_ns, end_ns) intervals, in seconds."""
    total = 0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-9
