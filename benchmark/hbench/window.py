"""The measured window over the program's own frame loop.

`Window` wraps one `Renderer`'s `render_frame` and `_finalize` (instance
attributes, so only that renderer is touched). The first `warmup` frames
are set-up (with DenoiseTemporal the second is the first that finalizes
against a history). The window opens when the next frame starts and
closes at the first frame start after `seconds`; there `WindowClosed`
stops the frame loop, so the last frame in the window has been rendered, finalized,
checkpointed and written. With `trace`, one more frame runs under the
device trace and the hooks before the loop is stopped. On a cell of n > 1
chips this is rank 0's window: `lockstep` hands its decision to the other
ranks at every frame start, the warm-up frames' included.

For the check it keeps, of every frame in the window, the film's AOVs at
the pixels `pick(frame)` names; and of every frame the loop finalized,
set-up frames included, the whole film (the finalize's input) and the
finalized image, so the reference can run the option's finalize itself
from the first frame on, its own history included.
"""

from __future__ import annotations

import time

import numpy as np

_AOVS = ("color", "albedo", "normal", "count")
# the film that the finalize reads
FILM = ("color", "albedo", "normal", "variance", "count")


class WindowClosed(Exception):
    pass


class Window:
    def __init__(self, renderer, seconds: float, pick, trace=None, warmup: int = 1,
                 lockstep=None):
        self.r = renderer
        self.warmup = int(warmup)
        self.seconds = float(seconds)
        self.pick = pick
        self.trace = trace  # (start(), stop()) around the traced frame, or None
        # on a cell of n > 1 chips, hands the stop to every rank at each
        # frame start (hbench.group.lockstep); None on one chip
        self.lockstep = lockstep
        self.first = None
        self.t_open = None
        self.t_close = None
        self.traced_frame = None
        self.samples = {}  # frame -> {aov: [n, c] at the picked pixels}
        self.films = {}  # frame -> the whole film the finalize read
        self.images = {}  # frame -> the finalized image
        self._render = renderer.render_frame
        self._finalize = renderer._finalize
        renderer.render_frame = self._render_frame
        renderer._finalize = self._finalize_hook

    def _render_frame(self, frame, *args, **kwargs):
        now = time.monotonic()
        stop = start_trace = False
        if self.first is None:
            self.first = frame
        if frame < self.first + self.warmup:
            pass
        elif self.t_open is None:
            self.t_open = now
        elif self.traced_frame is not None:
            self.trace[1]()
            stop = True
        elif now - self.t_open >= self.seconds:
            self.t_close = now
            if self.trace is None:
                stop = True
            else:
                self.traced_frame = frame
                start_trace = True
        if self.lockstep is not None:
            self.lockstep(stop)
        if stop:
            raise WindowClosed
        if start_trace:
            self.trace[0]()
        aovs = self._render(frame, *args, **kwargs)
        if self.t_open is not None:
            pix = self.pick(frame)
            got = {}
            for k in _AOVS:
                if k in aovs:
                    a = np.asarray(aovs[k])
                    got[k] = a.reshape(a.shape[0] * a.shape[1], -1)[pix]
            got["spp"] = int(aovs["spp_done"])
            self.samples[frame] = got
        return aovs

    def _finalize_hook(self, aovs, frame=None):
        img = self._finalize(aovs, frame=frame)
        self.films[frame] = {k: aovs.get(k) for k in FILM}
        self.images[frame] = img
        return img

    def window_frames(self, stats: list) -> list:
        """The program's frame_stats entries of the frames in the window."""
        end = self.traced_frame
        return [s for s in stats if s["frame"] >= self.first + self.warmup
                and (end is None or s["frame"] < end)]

    def in_window(self, frame: int) -> bool:
        """Whether `frame` rendered after set-up (the traced frame too)."""
        return frame >= self.first + self.warmup

    def traced_frames(self, stats: list) -> list:
        return [s for s in stats if s["frame"] == self.traced_frame]
