"""Wall-clock phase timing (port of henjou_tpu/utils/timer.py).

Kernels run asynchronously on the card, so a Timer must fence the device
to mean anything: `stop(fence)` synchronises the CUDA device of every
CUDA tensor in `fence` (a tensor or a nested list/tuple/dict of them)
before it reads the clock. CPU tensors need no fence.
"""

from __future__ import annotations

import contextlib
import logging
import time

import torch

log = logging.getLogger("henjou_torch")


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
