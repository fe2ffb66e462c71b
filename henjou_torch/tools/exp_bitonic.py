"""Variants of the payload-carrying bitonic sort, timed on the card.

Port of tools/exp_bitonic.py. Four rows, the JAX script's:

- ``switch 64k 10-plane`` / ``5-plane``: the whole network in one
  cooperative `net_walk` (the keyed network engine: shared-memory runs and
  fused global passes over (key, source) words, the planes gathered once),
  the first j of each global pass run by code compiled for it and picked
  by a switch on log2 j (the JAX kernel's fori_loop over a 17-way
  ``lax.switch``), into a new state;
- ``unroll 64k 10-plane`` / ``5-plane``: the schedule walked on the host
  (the JAX kernel's full static unroll): one `net_local` for every
  substage with k <= TILE, then for each k a `net_substage` per j >= TILE
  and one `net_local` for the rest, in place after the first (28 launches
  at n = 65,536).

Input: 65,536 keys below 2^24 from numpy's ``default_rng(0)``, then 9 or 4
payload planes below 2^30 from the same generator. Each row prints ``ok``
(the keys equal numpy's sort of the input keys), the first call's seconds
(in place of the JAX script's compile time) and the mean ms of 20 calls
after it (CUDA events on the card, the host clock on the CPU).

    python -m henjou_torch.tools.exp_bitonic --device cuda

This module also holds what the ports of exp_bitonic2-4 share: the timer,
the double-buffered loop and the row line. On CPU tensors the kernels'
plain versions run, which is practical only at toy sizes (`run_all`'s
keyword arguments).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from henjou_torch.accel import bitonic_net
from henjou_torch.accel.bitonic_net import TILE, make_schedule, substages
from henjou_torch.runtime.renderer import resolve_device

LANES = 128
REPS = 20
N = 1 << 16
VARIANTS = (
    ("switch 64k 10-plane", 9, "switch"),
    ("unroll 64k 10-plane", 9, "unroll"),
    ("switch 64k 5-plane", 4, "switch"),
    ("unroll 64k 5-plane", 4, "unroll"),
)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(fn, device: torch.device, reps: int = REPS):
    """Call `fn` once, synchronised (its seconds stand in for the JAX
    scripts' compile time), then `reps` more times: (first seconds, mean ms
    per call or None when reps is 0, the first call's result). The card
    times with CUDA events, the CPU with the host clock."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    first = time.perf_counter() - t0
    if reps == 0:
        return first, None, out
    if device.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        sync(device)
        return first, e0.elapsed_time(e1) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return first, (time.perf_counter() - t0) * 1e3 / reps, out


def pingpong(stack: torch.Tensor, iters: int, step):
    """The JAX scripts' double-buffered loop: out <- stack, then iteration
    s calls step(s, src, dst) from out to buf when s is even and from buf
    to out when odd. Returns (out, buf)."""
    out = stack.clone()
    buf = torch.empty_like(stack)
    for s in range(iters):
        src, dst = (out, buf) if s % 2 == 0 else (buf, out)
        step(s, src, dst)
    return out, buf


def keys_sorted(key_in: np.ndarray, out: torch.Tensor) -> bool:
    """The JAX scripts' check: the output keys equal numpy's sort."""
    return bool(np.array_equal(np.sort(key_in.reshape(-1)), out[0].cpu().numpy()))


def row_line(name, width, first_s, ms, *, ok=None, per_sub=None) -> str:
    """A row's line, in the JAX script's layout."""
    ok_s = f"ok={ok} " if ok is not None else ""
    ms_s = f"{ms:8.3f}" if ms is not None else "     n/a"
    line = f"{name:{width}s} {ok_s}first {first_s:6.2f}s  run {ms_s} ms"
    if per_sub is not None and ms is not None:
        line += f" ({ms / per_sub * 1e3:6.2f} us/substage)"
    return line


def row_result(name, out, first_s, ms, ok=None) -> dict:
    return dict(name=name, out=out, first_s=first_s, ms=ms, ok=ok)


def host_walk(stack: torch.Tensor, subs, ops) -> torch.Tensor:
    """The schedule `subs` walked on the host: each run of substages with
    j < TILE in one `net_local`, each other substage in one stacked
    `net_substage` with j compiled (mode "static_j"); the first launch
    reads `stack`, the rest run in place on the result."""
    out = torch.empty_like(stack)
    src = stack
    run = []

    def flush():
        nonlocal src
        if run:
            ops.net_local(src, run, dst=out)
            src = out
            run.clear()

    for k, j in subs:
        if j < TILE:
            run.append((k, j))
            continue
        flush()
        ops.net_substage(src, k, j, dst=out, mode="static_j")
        src = out
    flush()
    return out if subs else stack.clone()


def make_input(n: int, n_planes: int) -> np.ndarray:
    """[1 + n_planes, n] int32: keys below 2^24, then planes below 2^30,
    all from default_rng(0) in that order."""
    rng = np.random.default_rng(0)
    key = rng.integers(0, 1 << 24, n).astype(np.int32)
    planes = [rng.integers(0, 1 << 30, n).astype(np.int32) for _ in range(n_planes)]
    return np.stack([key] + planes)


def run_variant(name, n, n_planes, variant, device="cuda", *, state=None, reps=REPS,
                plain=False, log=print) -> dict:
    """One row: sort the [1 + n_planes, n] input (`state` when given, a
    numpy array, else `make_input`) by `variant` ("switch" or "unroll"),
    with the kernels or, with `plain`, their plain versions."""
    device = torch.device(device)
    inp = make_input(n, n_planes) if state is None else np.asarray(state, np.int32)
    stack = torch.from_numpy(inp).to(device)
    ops = bitonic_net.ops(plain)
    subs = substages(n)
    if variant == "switch":
        sched = make_schedule(subs, n, device)
        fn = lambda: ops.net_walk(stack, sched, switch=True)  # noqa: E731
    elif variant == "unroll":
        fn = lambda: host_walk(stack, subs, ops)  # noqa: E731
    else:
        raise ValueError(f"unknown variant {variant!r}")
    first_s, ms, out = time_calls(fn, device, reps)
    ok = keys_sorted(inp[0], out)
    log(row_line(name, 40, first_s, ms, ok=ok))
    return row_result(name, out, first_s, ms, ok)


def run_all(device="cuda", *, n=N, reps=REPS, plain=False, log=print) -> dict:
    """Every row at n keys: {name: row result}."""
    return {name: run_variant(name, n, n_planes, variant, device, reps=reps, plain=plain,
                              log=log)
            for name, n_planes, variant in VARIANTS}


def main(argv=None, **sizes) -> int:
    ap = argparse.ArgumentParser(description="bitonic sort variants (PyTorch/CUDA)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = run_all(device, log=lambda *a: print(*a, flush=True), **sizes)
    return 0 if all(r["ok"] for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
