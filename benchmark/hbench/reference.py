"""The plain reference's side of the check: the same option file, the same
pixels, worked out again by `plainref`."""

from __future__ import annotations

import numpy as np

from plainref.render import PlainRenderer


def reference_films(ref: PlainRenderer, frames, pick, engine: str, spp: int) -> dict:
    """frame -> {color, albedo, normal, count} at the pixels pick(frame)."""
    out = {}
    for frame in frames:
        f = ref.film(frame, pick(frame), spp, engine)
        out[frame] = {k: np.asarray(v).reshape(v.shape[0], -1) for k, v in f.items()}
    return out


def reference_finals(ref: PlainRenderer, films: dict) -> dict:
    """frame -> the reference's finalized image of the program's film of
    that frame, in frame order from the first frame the program finalized
    and from an empty history: each frame's history is the reference's own
    finalize of the frames before it, never the program's."""
    state, out = {}, {}
    for frame in sorted(films):
        out[frame], state = ref.finalize(frame, films[frame], state)
    return out
