"""Wall-clock phase timing (port of henjou_tpu/utils/timer.py), and the
program's spans and counters.

Kernels run asynchronously on the card, so a Timer must fence the device
to mean anything: `stop(fence)` synchronises the CUDA device of every
CUDA tensor in `fence` (a tensor or a nested list/tuple/dict of them)
before it reads the clock. CPU tensors need no fence.

`span(name)` and `count(name, n)` record only while a `torch.profiler`
session is on (the benchmark's traced frame, or ``render.py --profile``);
otherwise a span reads one module attribute and does nothing. A span
never fences: it stamps the host's `time.time_ns()`, the Unix-ns clock
of the profiler's events, so the device side of the same interval is
read from the trace. Each recorded span is [name, index of the enclosing
recorded span or -1, start ns, end ns]; `take()` hands over and clears
what was recorded (`Renderer.initialize_and_render` moves it into each
frame's `frame_stats` entry). NAMES lists every span the program opens.
A `tally()` block also takes every count made inside it, profiler or not.
"""

from __future__ import annotations

import contextlib
import logging
import time

import torch
from torch.autograd import profiler as _autograd_profiler

log = logging.getLogger("henjou_torch")

# every span the program opens, by where it sits
NAMES = (
    # the frame loop (runtime/renderer.py)
    "frame.scene", "frame.render", "engine.step", "frame.film_readback",
    "frame.checkpoint", "frame.finalize", "finalize.upload", "finalize.probe",
    "finalize.denoise", "finalize.readback", "frame.output",
    # the engines (integrator/): one bounce and its parts
    "engine.bounce", "engine.trace", "engine.shade", "engine.film", "engine.spawn",
    "engine.readback",
    # the sorted trace (accel/sorting.py) and the pool sort
    "accel.sort", "accel.intersect", "accel.unsort",
    # a frame's accel (runtime/renderer.py): the host pack of the first
    # transform set, the plan of the second, the device refresh of each later
    "accel.pack", "accel.plan", "accel.refresh",
    # one CMJ or Sobol draw (sampling/)
    "sampling.draw",
)


def _cuda_devices(x, out: set):
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    return out


def fence(x) -> None:
    """Wait for the work behind every CUDA tensor in `x`."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)


class Timer:
    def __init__(self):
        self._t0 = None
        self._elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, fence_value=None):
        if fence_value is not None:
            fence(fence_value)
        self._elapsed = time.perf_counter() - self._t0
        return self._elapsed

    @property
    def seconds(self) -> float:
        return self._elapsed

    @property
    def ms(self) -> float:
        return self._elapsed * 1e3

    @property
    def us(self) -> float:
        return self._elapsed * 1e6


@contextlib.contextmanager
def phase_log(name: str, fence_value=None):
    """A start/end banner with the phase's seconds."""
    log.info("---- %s start ----", name)
    t = Timer().start()
    try:
        yield t
    finally:
        t.stop(fence_value)
        log.info("---- %s end: %.3fs ----", name, t.seconds)


# what the running profiler session has recorded: spans in the order they
# opened, the indices of the open ones, and the counters
_SPANS: list = []
_OPEN: list = []
_COUNTS: dict = {}
# the open `tally` dicts, innermost last
_TALLIES: list = []


class _Off:
    """The span of a process with no profiler session: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class span:
    """``with span(name):`` records the host interval of its body while a
    profiler session is on. Inside a function body only: a decorator would
    give the function a closure."""

    __slots__ = ("_rec",)

    def __new__(cls, name: str):
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        self = object.__new__(cls)
        self._rec = [name, -1, 0, 0]
        return self

    def __enter__(self):
        rec = self._rec
        if _OPEN:
            rec[1] = _OPEN[-1]
        _OPEN.append(len(_SPANS))
        _SPANS.append(rec)
        rec[2] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._rec[3] = time.time_ns()
        if _OPEN:
            _OPEN.pop()
        return False


def count(name: str, n) -> None:
    """Add `n` (a host number) to counter `name` while a profiler session
    is on, and to every open `tally`."""
    for counts in _TALLIES:
        counts[name] = counts.get(name, 0) + n
    if _autograd_profiler._is_profiler_enabled:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


@contextlib.contextmanager
def tally():
    """``with tally() as counts:`` adds every `count` made in its body to
    the dict `counts`, with or without a profiler session (the wavefront
    engine keeps a graph capture's counts this way, to count them again at
    each replay)."""
    counts: dict = {}
    _TALLIES.append(counts)
    try:
        yield counts
    finally:
        _TALLIES.pop()


def take():
    """(spans, counters) recorded since the last call; clears both."""
    spans, counts = list(_SPANS), dict(_COUNTS)
    _SPANS.clear()
    _OPEN.clear()
    _COUNTS.clear()
    return spans, counts
