"""The comparison that decides `correct`: the program's film and finalized
image against the plain reference (`plainref`), each number beside its
limit.

Numbers (each cell's workload file gives their limits):
- film_mismatch_pct: percent of the checked pixels (drawn from the seed in
  every frame of the window) whose color, albedo or normal AOV differs
  from the reference's by more than ATOL + RTOL x |reference|;
- count_mismatch: checked pixels whose sample count differs (exact);
- final_mismatch_pct: over every frame the program finalized (set-up
  frames included), the largest percent of a frame's pixels whose
  finalized image differs from the reference's, by the same rule. The
  reference finalizes the program's films in frame order from an empty
  history, so its history is its own (see reference.reference_finals).
"""

from __future__ import annotations

import numpy as np

RTOL = 1e-3
ATOL = 1e-4
FILM_AOVS = ("color", "albedo", "normal")


def mismatched(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """[n] bool over rows of [n, c] arrays: some channel off the reference
    by more than ATOL + RTOL |ref|, or not finite."""
    prog = np.asarray(prog, np.float64).reshape(ref.shape[0], -1)
    ref = np.asarray(ref, np.float64).reshape(ref.shape[0], -1)
    bad = ~np.isfinite(prog) | (np.abs(prog - ref) > ATOL + RTOL * np.abs(ref))
    return bad.any(axis=1)


def film_numbers(samples: dict, refs: dict) -> dict:
    """samples/refs: frame -> {aov: [n, c]} of the program and reference at
    the same pixels."""
    n = bad = bad_count = 0
    for frame, ref in refs.items():
        got = samples[frame]
        off = np.zeros(ref["color"].shape[0], bool)
        for k in FILM_AOVS:
            off |= mismatched(got[k], ref[k])
        n += off.size
        bad += int(off.sum())
        if "count" in got:
            bad_count += int((np.asarray(got["count"]).reshape(-1)
                              != np.asarray(ref["count"]).reshape(-1)).sum())
    return {"film_mismatch_pct": 100.0 * bad / max(n, 1), "count_mismatch": float(bad_count)}


def final_numbers(images: dict, refs: dict) -> dict:
    """images/refs: frame -> [H, W, c] finalized image of the program and
    the reference."""
    worst = 0.0
    for frame, ref in refs.items():
        h, w = ref.shape[:2]
        off = mismatched(np.asarray(images[frame]).reshape(h * w, -1), ref.reshape(h * w, -1))
        worst = max(worst, 100.0 * float(off.mean()))
    return {"final_mismatch_pct": worst}


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a reading fails."""
    rows = []
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        rows.append((name, v, limit))
        ok &= v is not None and bool(np.isfinite(v)) and v <= limit
    return ok, rows
